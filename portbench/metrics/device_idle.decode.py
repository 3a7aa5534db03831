"""Percent of the decode with no device operation running: a traced
request of the cell's token count less the traced 1-token request, both in
wall and in busy time."""

from portbench.readers import idle_percent


def read(run):
    a, b = run.profiles.get("prefill"), run.profiles.get("request")
    if a is None or b is None:
        return None
    return idle_percent(b.busy_s - a.busy_s, b.wall_s - a.wall_s)
