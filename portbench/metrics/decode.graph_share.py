"""Share of the traced request's ``retake::decode.step`` spans that hold a
``retake::decode.replay`` span: the sequential decode steps replayed from
a CUDA graph ((n - 1) / n of n steps where the first runs eagerly and the
second captures). None where the trace holds no decode step."""

STEP, REPLAY = "retake::decode.step", "retake::decode.replay"


def read(run):
    p = run.profiles.get("request")
    steps = [] if p is None else [(ts, ts + d) for n, ts, d in p.host if n == STEP]
    if not steps:
        return None
    replays = [(ts, ts + d) for n, ts, d in p.host if n == REPLAY]
    held = sum(any(a <= ra and rb <= b for ra, rb in replays) for a, b in steps)
    return held / len(steps)
