"""Median host milliseconds of one ``retake::serve.segment`` span in the
traced stretch of serving: the host's cost to enqueue one segment of
batched decode steps (its uploads of the slot state included). None where
the trace holds no such span."""

from portbench.readers import median


def read(run):
    p = run.profiles.get("serve")
    durs = [] if p is None else [d for n, _, d in p.host if n == "retake::serve.segment"]
    return median(durs) / 1e3 if durs else None
