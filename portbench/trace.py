"""Device traces: ``torch.profiler`` over one stretch of work, read back
from its Chrome trace: the seconds the device was busy (the union of
kernel, copy and memset intervals), device time by kernel name, and the
idle gaps named by the host operation that was running when each began
(the busy / idle split of the port's ``tools/flash_timing.profiled``, with
the gaps added).
"""

from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Trace:
    def __init__(self, events: List[dict], wall_s: float):
        self.wall_s = wall_s
        dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e),
                     key=lambda e: e["ts"])
        self.device = [(e["name"], float(e["ts"]), float(e["dur"])) for e in dev]
        host = sorted((e for e in events if e.get("cat") in HOST_CATS and "dur" in e),
                      key=lambda e: e["ts"])
        self.host = [(e["name"], float(e["ts"]), float(e["dur"])) for e in host]
        self._starts = [h[1] for h in self.host]

    def merged(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for _, ts, dur in self.device:
            if out and ts <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], ts + dur))
            else:
                out.append((ts, ts + dur))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged()) / 1e6

    def device_s(self, patterns) -> float:
        """Device seconds of the operations whose name holds any pattern."""
        return sum(d for n, _, d in self.device if any(p in n for p in patterns)) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for name, _, dur in self.device:
            by[name[:120]] += dur / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float) -> str:
        i = bisect.bisect_right(self._starts, t)
        for j in range(i - 1, max(-1, i - 400), -1):  # the latest-starting op that covers t
            name, ts, dur = self.host[j]
            if ts + dur >= t:
                return name
        return "host (no traced op)"

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds between device operations, summed by the host
        operation running when each gap began; the ``n`` largest."""
        by: Dict[str, float] = defaultdict(float)
        spans = self.merged()
        for (_, end), (start, _) in zip(spans[:-1], spans[1:]):
            if start > end:
                by[self._host_at(end)[:120]] += (start - end) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def profile(fn: Callable[[], object], trace_dir: str, name: str) -> Tuple[object, Trace]:
    """Run ``fn()`` under the profiler (host and device activity); returns
    its value and the trace. The Chrome trace is written to ``trace_dir``
    and read back."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{name}.json")
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return out, Trace(events, wall)
