"""Percent of the chip's bf16 peak over the serving window: the prefill
and decode work of every request the window completed over the window,
from the start of the schedule to the last completion."""

from portbench import counts
from portbench.readers import request_flops


def read(run):
    done = [r for r in run.results if not r["failed"]]
    if not done or not run.window_s:
        return None
    work = sum(request_flops(run, r["frames"], len(r["tokens"]) - 1) for r in done)
    return 100.0 * work / (run.window_s * counts.PEAK_BF16_FLOPS)
