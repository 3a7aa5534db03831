"""Median time to the first token over every request of the window: from
the engine call to its first logits on the device, on the harness's clock;
none where a request's first token was not seen."""

from portbench.readers import median


def read(run):
    vals = [r["ttft_s"] for r in run.requests]
    return None if None in vals else median(vals)
