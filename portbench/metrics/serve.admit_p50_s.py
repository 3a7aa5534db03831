"""Median seconds of one ``retake::serve.admit`` span in the traced stretch
of serving: one admission's prefill with the blind decode segments the
server runs between its prefill steps, and the slot insertion. None where
the trace holds no such span."""

from portbench.readers import median


def read(run):
    p = run.profiles.get("serve")
    durs = [] if p is None else [d for n, _, d in p.host if n == "retake::serve.admit"]
    return median(durs) / 1e6 if durs else None
