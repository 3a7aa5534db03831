"""K2: PivotKV eviction score sums (CUDA kernel ``csrc/pivot_scores.cu``).

Replaces ``retake_tpu/ops/pallas/pivot_scores.py:pivot_score_sums``. Per KV
head, the column sums over valid query rows of softmax_row(q k^T / sqrt(d))
with keys ``>= valid_len`` masked, non-causal, chunk-local: [KV, S] fp32.
The caller divides ``sum(0)`` by KV*G and applies keypatch / padding
(``models/qwen2_vl/text.py``), which makes the result equal to
``ops.pivotkv.eviction_scores``.
"""

from __future__ import annotations

import math

import torch

from retake_tpu_torch.ops.cuda import _build, _checks

NEG_INF = -1e30
MAX_GROUP = 16


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
    valid_len,  # [1]/0-d int32 device tensor (int allowed on CPU)
) -> torch.Tensor:
    """Per-KV-head eviction score sums [KV, S] float32."""
    if q_score.device.type == "cpu":
        return pivot_score_sums_plain(q_score, k_score, valid_len)
    name = "pivot_score_sums"
    _checks.on_cuda(name, q_score, k_score)
    _checks.dtype(name, torch.bfloat16, q_score, k_score)
    h, s, d = q_score.shape
    kv = k_score.shape[0]
    if h % kv or h // kv > MAX_GROUP or d not in (64, 128):
        raise ValueError(f"{name}: unsupported heads {h}/{kv} or head_dim {d}")
    _checks.shape(name, k_score, (kv, s, d))
    vl = _checks.device_scalar(name, valid_len, q_score)
    n_qtiles = -(-s // 16)
    partial = torch.empty((kv, n_qtiles, s), dtype=torch.float32, device=q_score.device)
    out = torch.empty((kv, s), dtype=torch.float32, device=q_score.device)
    rc = _build.library().retake_pivot_scores_bf16(
        q_score.data_ptr(), k_score.data_ptr(), vl.data_ptr(),
        partial.data_ptr(), out.data_ptr(), kv, h // kv, s, d,
        _build.stream_of(q_score),
    )
    _build.check(rc, name)
    pivot_score_sums.launches += 1
    return out


pivot_score_sums.launches = 0
