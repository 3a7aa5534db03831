"""90th percentile of the time to the first token, on the harness's clock
from each request's due time to its first streamed token, over every
request due in the window; a failed request counts as missing (beyond any
limit)."""

from portbench.readers import quantile


def read(run):
    if not run.results:
        return None
    vals = [float("inf") if r["failed"] else r["first_token_s"] - r["arrival_s"]
            for r in run.results]
    p = quantile(vals, 0.9)
    return None if p == float("inf") else p
