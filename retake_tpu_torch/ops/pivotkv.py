"""PivotKV eviction math: attention-mass scoring and top-k compaction
(port of ``retake_tpu/ops/pivotkv.py``).

Eviction computes a compaction permutation over the fixed-size chunk: kept
token indices (ascending) first, evicted after. The caller writes the whole
permuted block at the cache's running offset and advances its length by
``keep_len``; the tail is overwritten by the next chunk and masked out of
attention.

Scoring: softmax(QK^T / sqrt(d)) in float32, non-causal, chunk-local keys;
summed over valid queries, mean over the query heads of each KV head, then
over KV heads. Keypatch (DPSelect peak) tokens score exactly 1.0; padding
tokens score -inf. Top-k ties resolve toward lower indices (stable sort).
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def eviction_scores(
    query: torch.Tensor,  # [num_heads, S, D] (RoPE'd, or de-rotated if reforge)
    key: torch.Tensor,  # [num_kv_heads, S, D]
    valid_mask: torch.Tensor,  # [S] bool — True for real (non-padding) tokens
    keypatch_mask: torch.Tensor | None,  # [S] bool or None
) -> torch.Tensor:
    """Per-key attention-mass scores, float32 [S]; padding keys get -inf."""
    num_heads, s, head_dim = query.shape
    num_kv_heads = key.shape[0]
    group = num_heads // num_kv_heads
    q = query.to(torch.float32).reshape(num_kv_heads, group, s, head_dim)
    logits = torch.matmul(
        q, key.to(torch.float32).transpose(-1, -2)[:, None]
    ) / torch.sqrt(torch.tensor(float(head_dim), dtype=torch.float32))
    logits = torch.where(valid_mask[None, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(valid_mask[None, None, :, None], probs, 0.0)
    scores = probs.sum(dim=2)  # [kv, group, S] — sum over queries
    scores = scores.mean(dim=1).mean(dim=0)  # [S]
    if keypatch_mask is not None:
        scores = torch.where(keypatch_mask, 1.0, scores)
    return torch.where(valid_mask, scores, NEG_INF)


def keep_partition(
    scores: torch.Tensor,  # [S] float32
    keep_len,  # int or 0-d int tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm [S] int64, kept_mask [S] bool): ``perm`` lists the indices of
    the top-``keep_len`` scores in ascending index order, then the evicted
    indices; ``kept_mask`` is ``arange(S) < keep_len``."""
    s = scores.shape[0]
    idx = torch.arange(s, device=scores.device)
    order = torch.sort(-scores, stable=True).indices  # rank -> index
    rank = torch.empty_like(idx).scatter_(0, order, idx)  # index -> rank
    kept = rank < keep_len
    sort_key = torch.where(kept, idx, idx + s)
    perm = torch.sort(sort_key, stable=True).indices
    return perm, idx < keep_len


def rescale_temporal_positions(
    temporal_pos: torch.Tensor,  # [S] int32 — perm-gathered temporal ids
    kept_mask: torch.Tensor,  # [S] bool — first keep_len entries are kept
    keep_len,  # int or 0-d int tensor
    chunk_len,  # int or 0-d int tensor — valid chunk tokens (k_len)
) -> torch.Tensor:
    """Squash kept temporal ids to a contiguous range (pos_embed_reforge):
    new_t = min_t + trunc((t - min_t) * keep_len / k_len) in float32 with
    the exact keep_len/k_len ratio. Entries outside ``kept_mask`` pass
    through unchanged."""
    # python scalars and device tensors only: a host value turned into a
    # CUDA tensor would synchronize the stream in every layer
    dev = temporal_pos.device
    min_t = torch.where(kept_mask, temporal_pos, 2**30).min()
    ratio = torch.as_tensor(keep_len, device=dev).to(torch.float32) / torch.as_tensor(
        chunk_len, device=dev
    ).to(torch.float32)
    scaled = min_t + ((temporal_pos - min_t).to(torch.float32) * ratio).to(
        temporal_pos.dtype
    )
    return torch.where(kept_mask, scaled, temporal_pos)


def dynamic_compression_ratio(input_length: int, max_input_length: int) -> float:
    """Cap the prefill KV footprint at ``max_input_length`` tokens."""
    if input_length <= max_input_length:
        return 1.0
    return max_input_length / input_length


def keep_len_for_chunk(ratio: float, chunk_valid_len):
    """keep_len = max(1, int(ratio * q_len)) — truncation, not rounding.
    Works on a python int or an int tensor (float32 product there)."""
    if isinstance(chunk_valid_len, int):
        return max(1, int(ratio * chunk_valid_len))
    kl = (chunk_valid_len.to(torch.float32) * ratio).to(torch.int32)  # ratio -> fp32
    return torch.clamp(kl, min=1)
