"""Arithmetic the metric readers share: percentiles, a kernel's share of
its roofline, a request's floating-point work, idle shares."""

from __future__ import annotations

import statistics
from typing import List, Optional

import numpy as np

from portbench import counts, program, traffic as traffic_lib
from portbench.reference import text as plan_lib


def quantile(values: List[float], q: float) -> float:
    """The q-quantile by linear interpolation between order statistics
    (numpy's default rule); infinite where it touches an infinite value."""
    v = sorted(float(x) for x in values)
    pos = q * (len(v) - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    if np.isinf(v[hi]) or np.isinf(v[lo]):
        return float("inf")
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None


def stage_median(run, *stages: str) -> Optional[float]:
    """The median over the window's requests of the summed seconds of the
    engine's ``stages`` (its stage timer, on in traced runs)."""
    vals = [sum(r["stages"].get(s, 0.0) for s in stages) for r in run.requests
            if any(s in r["stages"] for s in stages)]
    return median(vals)


BOUNDS = {
    "k1": lambda c: counts.k1_prefill(c["heads"], c["kv"], c["d"], c["cache_len"], c["valid"],
                                      c["int8_kv"]),
    "k2": lambda c: counts.k2_scores(c["heads"], c["kv"], c["d"], c["valid"]),
    "k3": lambda c: counts.k3_vit(c["t"], c["s"], c["n"], c["d"]),
    "k4": lambda c: counts.k4_decode(
        c["kv"], c["group"], c["d"],
        counts.k4_live_columns(c["final_len"], c["dec_start"], c["write_end"]), c["int8_kv"]),
}


def roofline(run, kernel: str, profile: str) -> Optional[float]:
    """Percent: the summed least time of every recorded call of ``kernel``
    over its summed device time in the traced ``profile``; None where the
    stretch launched it not."""
    calls = run.kernels.get(kernel, [])
    prof = run.profiles.get(profile)
    if not calls or prof is None:
        return None
    device = prof.device_s(program.KERNEL_NAMES[kernel])
    if device <= 0:
        return None
    bound = sum(counts.bound_seconds(BOUNDS[kernel](c)) for c in calls)
    return 100.0 * bound / device


def idle_percent(busy: float, wall: float) -> Optional[float]:
    return None if wall <= 0 else 100.0 * (1.0 - busy / wall)


def request_flops(run, frames: int, decode_tokens: int = 0) -> float:
    """The vision tower, the text prefill of the request's plan and
    ``decode_tokens`` decode steps, as the algorithm needs them."""
    cfg, tr = run.config, run.traffic
    ids, grid, chunk = traffic_lib.layout(run.family, cfg, tr, frames)
    retake = cfg["retake"]
    if run.family == "qwen2_vl":
        text, vid = cfg, cfg["video_token_id"]
        t, h, w = (int(x) for x in grid[0])
        vision = counts.qwen_vit_flops(cfg["vision_config"], t, h, w)
    else:
        text, vid = cfg["text_config"], cfg["video_token_index"]
        vision = counts.siglip_flops(cfg["vision_config"], text["hidden_size"], frames)
    steps = plan_lib.plan(ids, vid, chunk, plan_lib.compression_ratio(retake, len(ids)))
    total = vision + counts.prefill_flops(text, steps)
    if decode_tokens:
        final = sum(s["keep"] for s in steps)
        total += counts.decode_flops(text, final, decode_tokens)
    return total
