"""Percent of the chip's bf16 peak: the floating-point work the request's
algorithm needs up to its first token (vision tower, linears over the
prefilled tokens, attention over the [cache | chunk] each step visits, the
PivotKV scores) over the window's median time to the first token."""

from portbench import counts
from portbench.readers import median, request_flops


def read(run):
    vals = [r["ttft_s"] for r in run.requests]
    ttft = None if None in vals else median(vals)
    if not ttft:
        return None
    return 100.0 * request_flops(run, run.traffic["frames"]) / (ttft * counts.PEAK_BF16_FLOPS)
