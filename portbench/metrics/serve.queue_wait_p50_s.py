"""Median wait of a request between its arrival and the start of its
prefill (the server's admission), over the window: the server's own
``ServeResult`` span."""

from portbench.readers import median


def read(run):
    return median([r["queue_wait_s"] for r in run.results if not r["failed"]])
