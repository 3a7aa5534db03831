"""Per-phase timing hooks (port of ``retake_tpu/utils/profiling.py``).

``StageTimer`` accumulates wall time per pipeline phase (vision, dpselect,
prefill chunks, decode, ...). Enabled via RETAKE_PROFILE=1 or explicitly.
When enabled, each stage boundary calls ``torch.cuda.synchronize()`` so a
stage's time covers the device work it enqueued, not only the launches.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import torch


def device_fence() -> None:
    """Wait for all work enqueued on the current CUDA device (no-op on a
    host without CUDA)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StageTimer:
    def __init__(self, enabled: bool | None = None):
        self.enabled = (
            enabled
            if enabled is not None
            else os.environ.get("RETAKE_PROFILE", "") not in ("", "0")
        )
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        device_fence()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            device_fence()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        if not self.totals:
            return "(no stages recorded)"
        width = max(len(k) for k in self.totals)
        lines = [
            f"{k:<{width}}  {self.totals[k]:8.3f}s  x{self.counts[k]}"
            for k in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return "\n".join(lines)

    def report(self) -> None:
        if self.enabled:
            print("=== stage timing ===")
            print(self.summary())
