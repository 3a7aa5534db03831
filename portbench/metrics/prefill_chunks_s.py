"""Median seconds a request spends in its chunked prefill (every layer of
every chunk: K1, PivotKV with K2, the linears), from the engine's stage
timer."""

from portbench.readers import stage_median


def read(run):
    return stage_median(run, "prefill_chunks")
