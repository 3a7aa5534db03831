"""Attention primitives for the chunked-prefill runtime, plain torch
(port of ``retake_tpu/ops/attention.py``).

Key/value tensors have the full static budget shape and validity is a mask.
``chunk_prefill_attention`` is the plain version of K1
(``ops/cuda/flash_prefill.py``); decode has no kernel and runs
``decode_attention_appendfree`` here on every device.

Numerics: logits and softmax in float32; matmul inputs in the activation
dtype with float32 accumulation (the inputs are upcast before the product,
which is exact for bf16 values), outputs in the activation dtype.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def gqa_attention(
    query: torch.Tensor,  # [num_heads, S, D]
    key: torch.Tensor,  # [num_kv_heads, T, D]
    value: torch.Tensor,  # [num_kv_heads, T, D]
    mask: torch.Tensor,  # [S, T] bool — True = attend
) -> torch.Tensor:
    """Grouped-query attention with fp32 softmax. Returns [num_heads, S, D]."""
    num_heads, s, head_dim = query.shape
    num_kv_heads, t, _ = key.shape
    group = num_heads // num_kv_heads

    q = _f32(query).reshape(num_kv_heads, group, s, head_dim)
    logits = torch.matmul(q, _f32(key).transpose(-1, -2)[:, None]) / torch.sqrt(
        torch.tensor(float(head_dim), dtype=torch.float32)
    )
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(_f32(probs.to(value.dtype)), _f32(value)[:, None])
    return out.reshape(num_heads, s, head_dim).to(query.dtype)


def chunk_prefill_mask(
    budget: int,
    chunk_len: int,
    cache_len,  # int or 0-d int tensor — valid tokens in the cache buffer
    valid_len,  # int or 0-d int tensor — valid (non-pad) tokens in the chunk
    device=None,
) -> torch.Tensor:
    """[chunk_len, budget + chunk_len] bool mask.

    Chunk query i attends to all cached tokens < cache_len, plus chunk keys
    j <= i that are valid. Padding queries (i >= valid_len) keep a causal
    row so no softmax row is fully masked (their outputs are discarded).
    """
    qi = torch.arange(chunk_len, device=device)[:, None]
    cache_cols = torch.arange(budget, device=device)[None, :] < cache_len
    cache_part = cache_cols.expand(chunk_len, budget)
    kj = torch.arange(chunk_len, device=device)[None, :]
    chunk_part = (kj <= qi) & ((kj < valid_len) | (kj == qi))
    return torch.cat([cache_part, chunk_part], dim=1)


def chunk_prefill_attention(
    query: torch.Tensor,  # [H, S, D] RoPE'd chunk queries
    key_cache: torch.Tensor,  # [KV, budget, D]
    value_cache: torch.Tensor,  # [KV, budget, D]
    cache_len,  # int or 0-d int tensor
    key_new: torch.Tensor,  # [KV, S, D] RoPE'd chunk keys
    value_new: torch.Tensor,  # [KV, S, D]
    valid_len,  # int or 0-d int tensor
) -> torch.Tensor:
    """Attention for one prefill chunk: cached prefix + causal self block.
    The plain version of K1 (``ops/cuda/flash_prefill.py``)."""
    budget = key_cache.shape[1]
    s = query.shape[1]
    k = torch.cat([key_cache, key_new], dim=1)
    v = torch.cat([value_cache, value_new], dim=1)
    mask = chunk_prefill_mask(budget, s, cache_len, valid_len, query.device)
    return gqa_attention(query, k, v, mask)


def decode_attention_appendfree(
    query: torch.Tensor,  # [H, 1, D]
    key_cache: torch.Tensor,  # [KV, budget, D] (new token NOT yet appended)
    value_cache: torch.Tensor,
    cache_len,  # int or 0-d int tensor — valid cached tokens
    key_new: torch.Tensor,  # [KV, 1, D] the current token's key
    value_new: torch.Tensor,
) -> torch.Tensor:
    """Single-token attention without copying the cache: the new token's
    logit/value contribution is computed separately and merged into one
    softmax, so the cache is read once and never concatenated."""
    num_heads, _, head_dim = query.shape
    num_kv, budget, _ = key_cache.shape
    group = num_heads // num_kv
    q = _f32(query).reshape(num_kv, group, head_dim)
    scale = 1.0 / torch.sqrt(torch.tensor(float(head_dim), dtype=torch.float32))

    logits_c = torch.matmul(q, _f32(key_cache).transpose(-1, -2)) * scale
    live = torch.arange(budget, device=query.device) < cache_len
    logits_c = torch.where(live[None, None, :], logits_c, NEG_INF)  # [KV, G, T]
    logit_s = torch.matmul(q, _f32(key_new[:, 0])[:, :, None]) * scale  # [KV, G, 1]

    m = torch.maximum(logits_c.amax(dim=-1, keepdim=True), logit_s)
    p_c = torch.exp(logits_c - m)
    p_s = torch.exp(logit_s - m)
    denom = p_c.sum(dim=-1, keepdim=True) + p_s
    out = (
        torch.matmul(_f32(p_c.to(query.dtype)), _f32(value_cache))
        + p_s * _f32(value_new[:, 0])[:, None, :]
    ) / denom
    return out.reshape(num_heads, 1, head_dim).to(query.dtype)
