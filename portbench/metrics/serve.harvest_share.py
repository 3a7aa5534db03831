"""Percent of the traced stretch of serving, less the server's idle waits
(``retake::serve.wait``), spent in ``retake::serve.harvest`` spans: one
staged segment's tokens read to the host and streamed. None where the
trace holds no harvest span."""

HARVEST, WAIT = "retake::serve.harvest", "retake::serve.wait"


def read(run):
    p = run.profiles.get("serve")
    if p is None:
        return None
    harvest = [d for n, _, d in p.host if n == HARVEST]
    loaded = p.wall_s - sum(d for n, _, d in p.host if n == WAIT) / 1e6
    if not harvest or loaded <= 0:
        return None
    return 100.0 * sum(harvest) / 1e6 / loaded
