"""Milliseconds a decoded token: all decode time of the window (each
request's wall, ending in a device synchronize, minus its time to the first
token) over all its tokens after the first."""


def read(run):
    tokens = sum(len(r["tokens"]) - 1 for r in run.requests)
    if not tokens or any(r["ttft_s"] is None for r in run.requests):
        return None
    return 1e3 * sum(r["wall_s"] - r["ttft_s"] for r in run.requests) / tokens
