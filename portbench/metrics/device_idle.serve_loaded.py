"""Percent of the traced stretch of serving with no device operation
running, outside the server's idle waits for the next arrival (its
``retake::serve.wait`` spans): 100 x (1 - (busy - busy inside the waits) /
(wall - the summed waits)). It splits ``device_idle.serve`` into the time
with no request and the time the host holds the device back. None where the
trace holds no span of the serving loop."""

from portbench.readers import idle_percent

LOOP, WAIT = "retake::serve.", "retake::serve.wait"


def _overlap_us(spans, windows) -> float:
    """Microseconds of the sorted disjoint ``spans`` inside the sorted
    ``windows``."""
    total, j = 0.0, 0
    for a, b in windows:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            total += min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return total


def read(run):
    p = run.profiles.get("serve")
    if p is None or not any(name.startswith(LOOP) for name, _, _ in p.host):
        return None
    waits = [(ts, ts + dur) for name, ts, dur in p.host if name == WAIT]
    waited_us = sum(b - a for a, b in waits)
    busy_in_waits = _overlap_us(p.merged(), waits) / 1e6
    return idle_percent(p.busy_s - busy_in_waits, p.wall_s - waited_us / 1e6)
