"""Median host milliseconds of one ``retake::decode.step`` span in the
traced request of the cell's token count: the host's cost to enqueue one
sequential decode step, beside ``tpot_ms``. None where the trace holds no
such span."""

from portbench.readers import median


def read(run):
    p = run.profiles.get("request")
    durs = [] if p is None else [d for n, _, d in p.host if n == "retake::decode.step"]
    return median(durs) / 1e3 if durs else None
