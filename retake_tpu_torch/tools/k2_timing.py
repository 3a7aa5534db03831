"""Time K2, the PivotKV score-sum kernel, on one CUDA card at the main
path's shapes (one 2304-token prefill chunk).

    python3 -m retake_tpu_torch.tools.k2_timing

Run from the root of a checkout, it times that checkout's
``retake_tpu_torch`` (with ``k4_timing``'s timers: copy both files into the
other checkout's package to compare two commits). Prints one JSON line: the
module it timed, the card's name and power limit, and for each case

* ``ms``: median CUDA-event time of one wrapper call (host launch work
  included, L2 warm);
* ``device_ms``: device time of one call (``k4_timing.graph_ms``);
* ``bound_ms``: the larger of 2*D*H*S^2 operations (one Q K^T pass over the
  valid square) over 989 TFLOP/s bf16 and q, k in and [KV, S] f32 out over
  3.35 TB/s; ``exp_ms``: H*S^2 exponentials over the special-function
  units' rate; ``floor_ms``: two passes of the larger of the two, the least
  time of a design that recomputes the logits.

Cases: ``2b`` (12 query / 2 KV heads), ``2b_short`` (the same, valid_len
1999), ``7b`` (28 / 4 heads); D = 128, S = 2304.
"""

from __future__ import annotations

import json
import subprocess

import torch

from retake_tpu_torch.tools.k4_timing import cuda_ms, graph_ms

D, S = 128, 2304
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# ex2 results per second over the card: 16 a clock per SM (the CUDA
# programming guide's throughput table, compute capability 9.0) x 132 SMs x
# 1.98 GHz (the H100 SXM's highest boost clock)
PEAK_EX2_PER_S = 16 * 132 * 1.98e9
# (name, query heads, KV heads, valid_len)
CASES = [("2b", 12, 2, 2304), ("2b_short", 12, 2, 1999), ("7b", 28, 4, 2304)]


def work(heads: int, kv: int, s: int, d: int, valid_len: int) -> dict:
    """K2's bound on these inputs and the terms beside it, in ms."""
    flops = 2 * d * heads * valid_len * valid_len
    nbytes = 2 * heads * s * d + 2 * kv * s * d + 4 * kv * s
    t_ops, t_bytes = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    t_exp = 1e3 * heads * valid_len * valid_len / PEAK_EX2_PER_S
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                exp_ms=t_exp, floor_ms=2 * max(t_ops, t_exp))


def time_cases() -> dict:
    from retake_tpu_torch.ops.cuda import pivot_scores

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    k2 = pivot_scores.pivot_score_sums
    out = {"module": pivot_scores.__file__, "card": card, "cases": {}}
    for name, h, kv, valid_len in CASES:
        q = torch.randn((h, S, D), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((kv, S, D), generator=gen, device=dev).to(torch.bfloat16)
        vl = torch.tensor(valid_len, dtype=torch.int32, device=dev)
        out["cases"][name] = dict(ms=cuda_ms(lambda: k2(q, k, vl)),
                                  device_ms=graph_ms(lambda: k2(q, k, vl)),
                                  **work(h, kv, S, D, valid_len))
        del q, k
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("k2_timing needs a CUDA device")
    print(json.dumps(time_cases()), flush=True)
