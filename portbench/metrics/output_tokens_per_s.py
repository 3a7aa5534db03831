"""Tokens the window's requests streamed to their users over the window,
from the start of the schedule to the last completion (the server's
``run`` returns at it), both on the harness's clock."""


def read(run):
    done = [r for r in run.results if not r["failed"]]
    if not done or not run.window_s:
        return None
    return sum(len(r["tokens"]) for r in done) / run.window_s
