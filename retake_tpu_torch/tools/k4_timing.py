"""Time K4, the batched gap-layout decode kernel (both modes), on one CUDA
card at the serving shapes of ``chip_smoke.py`` phase 3.

    python3 -m retake_tpu_torch.tools.k4_timing

Run from the root of a checkout, it times that checkout's
``retake_tpu_torch``: to compare two commits, copy this file into the other
checkout's package and run it there too. Prints one JSON line: the module it
timed, the card's name and power limit, and for each case

* ``ms``: median CUDA-event time of one wrapper call (host launch work
  included, L2 warm);
* ``host_ms``: host time of one call, 100 calls enqueued back to back;
* ``device_ms``: device time of one call (``graph_ms``);
* ``bound_ms``: the live K/V bytes and the outputs over 3.35 TB/s.

Cases: ``2b`` (4 slots, 2 KV heads, G = 6, the 43008-column bucket, bf16),
``7b_int8`` (4 slots, 4 KV heads, G = 7, int8 K/V) and ``tiny`` (one slot,
one head, 64 live columns: what a call costs beyond its bytes).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import torch

D = 128
PEAK_BYTES_PER_S = 3.35e12
# (name, B, KV, G, S, final_len, dec_start, write_end, int8)
CASES = [
    ("2b", 4, 2, 6, 43008, [32002, 18498, 4674, 0], [40960, 40976, 40992, 40960], 41024, False),
    ("7b_int8", 4, 4, 7, 43008, [32002, 18498, 4674, 20000], [40960] * 4, 41024, True),
    ("tiny", 1, 1, 6, 512, [64], [512], 512, False),
]


def cuda_ms(fn, reps: int = 50) -> float:
    """Median CUDA-event time of one call of ``fn`` in ms."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, n: int = 50) -> float:
    """Device time of one call of ``fn`` in ms: ``n`` calls captured in one
    CUDA graph after an eager warm-up call, the graph's replay timed by CUDA
    events (median of 5), over ``n``. The host's launch work is left out;
    the gaps between the graph's kernels are in."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return statistics.median(times)


def time_cases() -> dict:
    from retake_tpu_torch.ops.cuda import decode_gapped
    from retake_tpu_torch.ops.quantization import quantize_kv_block

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    k4 = decode_gapped.decode_gapped_flash_state
    out = {"module": decode_gapped.__file__, "card": card, "cases": {}}
    for name, b, kv, g, s, fl, ds, we, int8 in CASES:
        randn = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
        i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
        q, kc, vc = randn(b, kv, g, D), randn(b, kv, s, D), randn(b, kv, s, D)
        args = [q, kc, vc, i32(fl), i32(ds), we]
        if int8:
            (kc, ks), (vc, vs) = quantize_kv_block(kc), quantize_kv_block(vc)
            args = [q, kc, vc, i32(fl), i32(ds), we, ks, vs]
        live = sum(fl) + sum(we - x for x in ds)
        nbytes = (live * kv * (2 * D + 8 if int8 else 4 * D) + 2 * b * kv * g * D
                  + 4 * b * kv * g * (D + 2))
        k4(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            k4(*args)
        host_ms = 1e3 * (time.perf_counter() - t0) / 100
        torch.cuda.synchronize()
        out["cases"][name] = {
            "ms": cuda_ms(lambda: k4(*args)),
            "host_ms": host_ms,
            "device_ms": graph_ms(lambda: k4(*args)),
            "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
        }
        del q, kc, vc, args
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("k4_timing needs a CUDA device")
    print(json.dumps(time_cases()), flush=True)
