"""Percent of a traced 1-token request (its prefill) with no device
operation running."""

from portbench.readers import idle_percent


def read(run):
    p = run.profiles.get("prefill")
    return None if p is None else idle_percent(p.busy_s, p.wall_s)
