"""K2: PivotKV eviction score sums (CUDA kernel ``csrc/pivot_scores.cu``).

Replaces ``retake_tpu/ops/pallas/pivot_scores.py:pivot_score_sums``. Per KV
head, the column sums over valid query rows of softmax_row(q k^T / sqrt(d))
with keys ``>= valid_len`` masked, non-causal, chunk-local: [KV, S] fp32.
The caller divides ``sum(0)`` by KV*G and applies keypatch / padding
(``models/qwen2_vl/text.py``), which makes the result equal to
``ops.pivotkv.eviction_scores``.

One call is three launches (counted as one): the first writes every query
row's log2-sum-exp to a workspace, the second sums each query head's
softmax down each key column into a second workspace, the third adds the G
heads' sums of each key in head order. The workspace (2 x [H, S padded to
BQ] f32) is made once per (device, size) and reused by every later call of
that size: calls on one stream run in order, so no two launches share it
at once (calls on two streams at once with one size would). Nothing else is
allocated but the output, so a call can be captured in a CUDA graph.
"""

from __future__ import annotations

import math

import torch

from retake_tpu_torch.ops.cuda import _build, _checks
from retake_tpu_torch.utils.profiling import span

NEG_INF = -1e30
# the kernel's fixed plan (csrc/pivot_scores.cu): rows of the fixed block
# per CTA (two consumer warpgroups of 64), rows of a streamed tile, ring
# stages, threads (+ one producer warp), keys per CTA of the merge; the most
# query rows per KV head
BQ = 128
BN = 128
STAGES = 2
BLOCK = 2 * 128 + 32
MERGE_BLOCK = 256
MAX_GROUP = 16


def launch_plan(heads: int, num_kv: int, s: int, d: int) -> dict:
    """Grids, blocks, dynamic shared memory and workspace of one K2 call, as
    the kernel's constants fix them. ``rows`` (launch 1): one CTA per (query
    head, BQ query rows), head index fastest. ``cols`` (launch 2): one CTA
    per (query head of the group, BQ keys, KV head). ``merge`` (launch 3):
    one thread per (key, KV head). Shared memory of launches 1 and 2 (the
    kernel's ``Layout``): 1024 bytes of alignment slack, the fixed block of
    BQ bf16 rows, STAGES streamed tiles of BN bf16 rows, STAGES x BN f32 row
    statistics and 2 x STAGES + 1 mbarriers. The workspace holds two f32 per (query head, padded row):
    the row statistic launch 1 writes and the column sum launch 2 writes
    for that head and key. Raises on what the kernel does not take."""
    if num_kv < 1 or heads % num_kv or not (1 <= heads // num_kv <= MAX_GROUP) or d not in (64, 128):
        raise ValueError(f"K2: unsupported heads {heads}/{num_kv} or head_dim {d}")
    n_blocks = -(-s // BQ)
    if s < 1 or n_blocks > 65535 or num_kv > 65535:
        raise ValueError(f"K2: S {s} or {num_kv} KV heads exceed the kernel's grid")
    return dict(rows=dict(grid=(heads, n_blocks)),
                cols=dict(grid=(heads // num_kv, n_blocks, num_kv)),
                merge=dict(grid=(-(-s // MERGE_BLOCK), num_kv), block=MERGE_BLOCK),
                block=BLOCK, bq=BQ, bn=BN, stages=STAGES,
                smem_bytes=(1024 + BQ * d * 2 + STAGES * (BN * d * 2 + BN * 4)
                            + 8 * (2 * STAGES + 1)),
                workspace_floats=2 * heads * n_blocks * BQ)


# (device, workspace floats) -> the row statistics and column sums, made once and reused
_workspaces: dict = {}


def _workspace(dev, n: int) -> torch.Tensor:
    ws = _workspaces.get((dev, n))
    if ws is None:
        ws = torch.empty(n, dtype=torch.float32, device=dev)
        _workspaces[(dev, n)] = ws
    return ws


def pivot_score_sums_plain(
    q_score: torch.Tensor,  # [H, S, D]
    k_score: torch.Tensor,  # [KV, S, D]
    valid_len,  # int or int tensor
) -> torch.Tensor:
    """Plain version of K2: [KV, S] float32 column sums."""
    h, s, d = q_score.shape
    kv = k_score.shape[0]
    q = q_score.to(torch.float32).reshape(kv, h // kv, s, d)
    k = k_score.to(torch.float32)
    logits = torch.matmul(q, k.transpose(-1, -2)[:, None]) * (1.0 / math.sqrt(d))
    idx = torch.arange(s, device=q_score.device)
    live = idx < valid_len
    logits = torch.where(live[None, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    w = torch.where(live[None, None, :, None], 1.0 / torch.clamp(l, min=1e-37), 0.0)
    return (p * w).sum(dim=(1, 2))


def pivot_score_sums(
    q_score: torch.Tensor,  # [H, S, D] scoring queries (de-rotated if reforge)
    k_score: torch.Tensor,  # [KV, S, D] scoring keys
    valid_len,  # [1]/0-d int32 device tensor in [1, S] (int allowed on CPU)
) -> torch.Tensor:
    """Per-KV-head eviction score sums [KV, S] float32."""
    if q_score.device.type == "cpu":
        return pivot_score_sums_plain(q_score, k_score, valid_len)
    name = "pivot_score_sums"
    _checks.on_cuda(name, q_score, k_score)
    _checks.dtype(name, torch.bfloat16, q_score, k_score)
    h, s, d = q_score.shape
    kv = k_score.shape[0]
    plan = launch_plan(h, kv, s, d)  # refuses what the kernel does not take
    _checks.shape(name, k_score, (kv, s, d))
    for t in (q_score, k_score):
        if t.data_ptr() % 16:  # TMA reads from 16-byte-aligned addresses
            raise ValueError(f"{name}: tensors must start on a 16-byte boundary")
    vl = _checks.device_scalar(name, valid_len, q_score)
    work = _workspace(q_score.device, plan["workspace_floats"])
    out = torch.empty((kv, s), dtype=torch.float32, device=q_score.device)
    with span("k2"):
        rc = _build.library().retake_pivot_scores_bf16(
            q_score.data_ptr(), k_score.data_ptr(), vl.data_ptr(),
            work.data_ptr(), out.data_ptr(), kv, h // kv, s, d,
            _build.stream_of(q_score),
        )
    _build.check(rc, name)
    pivot_score_sums.launches += 1
    return out


pivot_score_sums.launches = 0
