"""Percent of a traced stretch of serving (the requests due in its first
``profiled_seconds``) with no device operation running."""

from portbench.readers import idle_percent


def read(run):
    p = run.profiles.get("serve")
    return None if p is None else idle_percent(p.busy_s, p.wall_s)
