"""Arithmetic the metric readers share: percentiles, a kernel's share of
its roofline, a request's floating-point work, idle shares."""

from __future__ import annotations

import statistics
from typing import List, Optional

import numpy as np

from portbench import counts, spec, traffic as traffic_lib


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


def roofline(run, kernel: str, profile: str) -> Optional[float]:
    """Percent: the summed least time of every recorded call of ``kernel``
    (its module's ``count``) over its summed device time (its
    ``DEVICE_NAMES``) in the traced ``profile``; None where the stretch
    launched it not."""
    calls = run.kernels.get(kernel, [])
    prof = run.profiles.get(profile)
    if not calls or prof is None:
        return None
    kmod = (getattr(run, "kernel_modules", None) or spec.kernels())[kernel]
    device = prof.device_s(kmod.DEVICE_NAMES)
    if device <= 0:
        return None
    bound = sum(counts.bound_seconds(kmod.count(c)) for c in calls)
    return 100.0 * bound / device


def idle_percent(busy: float, wall: float) -> Optional[float]:
    return None if wall <= 0 else 100.0 * (1.0 - busy / wall)


def request_flops(run, frames: int, decode_tokens: int = 0) -> float:
    """The vision tower, the text prefill of the request's plan and
    ``decode_tokens`` decode steps, as the algorithm needs them (the model
    family's ``request_flops``)."""
    fam = traffic_lib.family_module(run.family)
    return fam.request_flops(run.config, run.traffic, frames, decode_tokens)
