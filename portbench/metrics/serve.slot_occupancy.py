"""Percent of the decode slots' steps that emitted a token: the server's
tokens emitted over its segments x steps x slots in the window."""


def read(run):
    s = run.stats
    steps = s.get("segments_dispatched", 0) * s.get("segment_steps", 0) * s.get("batch_slots", 0)
    return None if not steps else 100.0 * s["tokens_emitted"] / steps
