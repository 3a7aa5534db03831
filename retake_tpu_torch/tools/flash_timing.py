"""Where the time of the ``attn_implementation: "flash"`` arm goes, on one
CUDA card, beside the ``"pallas"`` arm (K1 / K2).

    python3 -m retake_tpu_torch.tools.flash_timing [--frames 512]

Builds the 2B model with random bf16 weights (seed 0) and the bench
request (``tools/bench_model.py``'s ``build_request`` and ``RETAKE_CONFIG``:
``--frames`` random frames at 448x252). For each arm:
one warm-up request, one timed request (its TTFT), one request under
torch.profiler. Then one ``flash_chunk_attention`` call
at a chunk of that request (S = 2304 rows over a 40960-key budget filled to
16000), timed with CUDA events and profiled alone.

Prints one JSON line: the module it timed, the card's name and power limit
and, for each arm and for the op, the wall time, the device-busy time, and
that busy time split into matrix products (cuBLAS / CUTLASS GEMM kernels),
the port's kernels (K1-K4) and the rest (elementwise, reductions, copies);
``idle_s`` is wall minus busy, the time the device waited on the host.
Run from the root of a checkout, it times that checkout's
``retake_tpu_torch``: to compare two commits, copy this file into the
other checkout's package and run it there too.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from typing import Optional

import torch

GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "splitKreduce")
PORT_NAMES = ("flash_prefill_kernel", "row_stats_kernel", "col_sums_kernel", "::merge_kernel",
              "vit_attention_kernel", "decode_gapped_kernel")


def profiled(fn, cuda: bool = True, trace_path: Optional[str] = None) -> dict:
    """``fn()`` under torch.profiler: wall, device busy and its split
    (``cuda=False``: host activity only, busy 0); ``trace_path``: also
    write the Chrome trace there."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not e.key.startswith("Command Buffer")]
    sec = lambda es: sum(e.self_device_time_total for e in es) / 1e6  # noqa: E731
    gemm = [e for e in kern if any(n in e.key for n in GEMM_NAMES)]
    port = [e for e in kern if any(n in e.key for n in PORT_NAMES)]
    busy = sec(kern)
    top = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    return {"wall_s": wall, "busy_s": busy, "idle_s": wall - busy, "gemm_s": sec(gemm),
            "port_kernels_s": sec(port), "rest_s": busy - sec(gemm) - sec(port),
            "launches": sum(e.count for e in kern),
            "top": [[e.key[:80], e.self_device_time_total / 1e6, e.count] for e in top]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=512)
    args = ap.parse_args()

    import retake_tpu_torch
    from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
    from retake_tpu_torch.ops.attention import flash_chunk_attention
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine
    from retake_tpu_torch.tools.bench_model import RETAKE_CONFIG, build_model, build_request
    from retake_tpu_torch.utils.config import RetakeConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg, params = build_model(dev)
    model = Qwen2VLModel(cfg, params)
    del params
    ids, patches, grid = build_request(cfg, args.frames, dev, 0)
    out = {"module": retake_tpu_torch.__file__, "device": smi, "frames": args.frames}
    with torch.no_grad():
        for impl in ("flash", "pallas"):
            eng = Qwen2VLEngine(cfg, model, RetakeConfig.from_dict(
                dict(RETAKE_CONFIG, attn_implementation=impl)), device=dev)
            run = lambda: eng.generate(ids, patches, grid, max_new_tokens=1)  # noqa: E731
            run()
            ttft = run().prefill_seconds
            out[impl] = dict(ttft_s=ttft, **profiled(run))
            del eng
        del model, patches
        torch.cuda.empty_cache()

        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        bf = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
        h, kv, s, d, budget = cfg.num_attention_heads, cfg.num_key_value_heads, 2304, 128, 40960
        q, kn, vn = bf(h, s, d), bf(kv, s, d), bf(kv, s, d)
        kc, vc = bf(kv, budget, d), bf(kv, budget, d)
        cl, vl = torch.tensor(16000, device=dev), torch.tensor(s, device=dev)
        op = lambda: flash_chunk_attention(q, kc, vc, cl, kn, vn, vl)  # noqa: E731
        op()
        times, host = [], []
        for _ in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            t0 = time.perf_counter()
            op()
            host.append(time.perf_counter() - t0)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        shape = dict(heads=h, kv=kv, s=s, d=d, budget=budget, cache_len=16000)
        out["flash_op"] = dict(shape=shape,
                               event_s=statistics.median(times), host_s=statistics.median(host),
                               **profiled(op))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
