"""A torch.profiler trace of one ``generate`` (port of ``tools/profile_trace.py``).

Builds the bench model and request (Qwen2-VL-2B, random weights; ``--tiny``:
the tiny geometry and a processed random video) at ``--frames`` frames
under the bench config (the kernels), runs one warm-up ``generate``, then one under
torch.profiler with host and CUDA activity (``flash_timing.profiled``) and
writes its Chrome trace to ``<out>/trace.json`` (open it in Perfetto or
chrome://tracing). Prints one JSON line: the trace's path, the prefill and
decode seconds, and the profile's wall, device-busy and top kernels. The
trace holds the port's own ranges (``utils/profiling.span``, named
``retake::<name>``: the request, its vision chunks, plan, prefill steps and
decode steps, the decoder layers' parts and the kernel launches) on the
kernels' clock. Without the profiler, ``utils/profiling.StageTimer``
(``RETAKE_PROFILE=1``) times the engine's stages from CUDA events.

Usage:
  python3 -m retake_tpu_torch.tools.profile_trace --frames 256 --out results/retake_trace
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--out", type=str, default="results/retake_trace")
    p.add_argument("--max_new_tokens", type=int, default=16)
    p.add_argument("--tiny", action="store_true", help="tiny random geometry")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def record(argv: Optional[List[str]] = None) -> dict:
    """Profile one request; returns ``trace``, ``prefill_s``, ``decode_s``
    and the profile's summary (``flash_timing.profiled``)."""
    return run(parse_args(argv))


def run(args: argparse.Namespace) -> dict:
    from retake_tpu_torch.tools.bench_model import RETAKE_CONFIG
    from retake_tpu_torch.tools.cal_ttft import build
    from retake_tpu_torch.tools.flash_timing import profiled
    from retake_tpu_torch.utils.config import RetakeConfig

    args.hf_path, args.random_weights = None, not args.tiny
    engine, ids, patches, grid = build(args, RetakeConfig.from_dict(RETAKE_CONFIG))

    def request():
        return engine.generate(ids, patches, grid, max_new_tokens=args.max_new_tokens)

    request()  # warm-up: kernel loads, allocator
    results = []
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, "trace.json")
    prof = profiled(lambda: results.append(request()), cuda=engine.device.type == "cuda",
                    trace_path=trace)
    r = results[0]
    print(f"trace written to {trace} | prefill {r.prefill_seconds:.2f}s decode "
          f"{r.decode_seconds:.2f}s")
    return {"trace": trace, "prefill_s": r.prefill_seconds, "decode_s": r.decode_seconds,
            "frames": args.frames, **prof}


def main(argv: Optional[List[str]] = None) -> int:
    print(json.dumps(record(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
