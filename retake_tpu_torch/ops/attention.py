"""Attention primitives for the chunked-prefill runtime, plain torch
(port of ``retake_tpu/ops/attention.py``).

Key/value tensors have the full static budget shape and validity is a mask.
``chunk_prefill_attention`` is the plain version of K1
(``ops/cuda/flash_prefill.py``); ``flash_chunk_attention`` is the blocked
online-softmax arm that ``attn_implementation: flash`` selects (plain torch
here, as it is plain XLA in the JAX package: no kernel); sequential decode has no kernel and runs
``decode_attention_appendfree`` here on every device. Batched decode over
the gap-layout cache (``decode_attention_batch_gapped``) has two arms:
``"pallas"`` calls K4 (``ops/cuda/decode_gapped.py``) and merges the current
token, ``"xla"`` is the masked full-bucket softmax, K4's plain twin.

int8 KV cache (``k_scale`` / ``v_scale``, per key): chunk attention
dequantizes the cache (``dequantize_cache``, as K1 does); the decode
attentions commute the scales instead, ``(q . k_q) * s_k`` and
``(p * s_v) . v_q``, so no dequantized cache is made (as K4 does). The
current token's key/value stay in the activation dtype.

Numerics: logits and softmax in float32; matmul inputs in the activation
dtype with float32 accumulation (the inputs are upcast before the product,
which is exact for bf16 values and for int8), outputs in the activation
dtype.
"""

from __future__ import annotations

import torch

from retake_tpu_torch.ops.cuda import decode_gapped

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


def dequantize_cache(cache_part: torch.Tensor, scale, dtype) -> torch.Tensor:
    """int8 [.., S, D] with per-key scale [.., S] -> ``dtype``: the fp32
    product rounded once (``bf16(f32(k) * s)``). No scale: unchanged."""
    if scale is None:
        return cache_part
    return (cache_part.to(torch.float32) * scale[..., None]).to(dtype)


def chunk_prefill_attention(
    query: torch.Tensor,  # [H, S, D] RoPE'd chunk queries
    key_cache: torch.Tensor,  # [KV, budget, D] (int8 with k_scale)
    value_cache: torch.Tensor,  # [KV, budget, D]
    cache_len,  # int or 0-d int tensor
    key_new: torch.Tensor,  # [KV, S, D] RoPE'd chunk keys
    value_new: torch.Tensor,  # [KV, S, D]
    valid_len,  # int or 0-d int tensor
    k_scale=None,  # [KV, budget] f32 (int8 cache)
    v_scale=None,
) -> torch.Tensor:
    """Attention for one prefill chunk: cached prefix + causal self block.
    The plain version of K1 (``ops/cuda/flash_prefill.py``)."""
    budget = key_cache.shape[1]
    s = query.shape[1]
    key_cache = dequantize_cache(key_cache, k_scale, query.dtype)
    value_cache = dequantize_cache(value_cache, v_scale, query.dtype)
    k = torch.cat([key_cache, key_new], dim=1)
    v = torch.cat([value_cache, value_new], dim=1)
    mask = chunk_prefill_mask(budget, s, cache_len, valid_len, query.device)
    return gqa_attention(query, k, v, mask)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, M, K] @ [N, K, P] -> fp32 [N, M, P] with the inputs in their own
    dtype: on CUDA a bf16 product runs on the tensor cores with fp32
    accumulation and an fp32 result (the JAX arm's
    ``preferred_element_type=float32``); elsewhere the inputs are widened,
    which is exact (a bf16 x bf16 product fits fp32)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(_f32(a), _f32(b))


def flash_chunk_attention(
    query: torch.Tensor,  # [H, S, D] RoPE'd chunk queries
    key_cache: torch.Tensor,  # [KV, budget, D] (int8 with k_scale)
    value_cache: torch.Tensor,
    cache_len,  # int or 0-d int tensor
    key_new: torch.Tensor,  # [KV, S, D]
    value_new: torch.Tensor,
    valid_len,  # int or 0-d int tensor
    block_size: int = 1024,
    k_scale=None,  # [KV, budget] f32 (int8 cache)
    v_scale=None,
) -> torch.Tensor:
    """Online-softmax chunk attention over key blocks of ``block_size``:
    the masking of ``chunk_prefill_attention`` without the full probability
    matrix (the ``attn_implementation: flash`` arm; plain torch, as the JAX
    arm is plain XLA). The products take their inputs in the activation
    dtype and give fp32 (``_bmm_f32``); the state (m, l, acc) is fp32.
    Blocks are sliced from the cache and the chunk as they are, never
    concatenated or padded; a tail block starts ``block_size`` before the
    end and masks the columns an earlier block covered. An int8 cache is
    dequantized block by block."""
    num_heads, s, head_dim = query.shape
    num_kv = key_cache.shape[0]
    group = num_heads // num_kv
    q = query.reshape(num_kv, group * s, head_dim)
    scale = 1.0 / torch.sqrt(torch.tensor(float(head_dim), dtype=torch.float32))
    qi = torch.arange(s, device=query.device)[:, None]

    def phase(k_src, v_src, mask_fn, state, ks_src=None, vs_src=None):
        m, l, acc = state
        total = k_src.shape[1]
        block = min(block_size, total)
        for start in range(0, total, block):
            cstart = min(start, total - block)
            kb, vb = k_src[:, cstart : cstart + block], v_src[:, cstart : cstart + block]
            if ks_src is not None:
                kb = dequantize_cache(kb, ks_src[:, cstart : cstart + block], query.dtype)
                vb = dequantize_cache(vb, vs_src[:, cstart : cstart + block], query.dtype)
            col = cstart + torch.arange(block, device=query.device)[None, :]
            mask = mask_fn(col) & (col >= start)  # [S or 1, block]
            logits = _bmm_f32(q, kb.transpose(-1, -2)).view(num_kv, group, s, block) * scale
            logits = torch.where(mask[None, None], logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = _bmm_f32(p.to(vb.dtype).view(num_kv, group * s, block), vb)
            acc = acc * alpha[..., None] + pv.view(num_kv, group, s, head_dim)
            m = m_new
        return m, l, acc

    state = (
        torch.full((num_kv, group, s), NEG_INF, dtype=torch.float32, device=query.device),
        torch.zeros((num_kv, group, s), dtype=torch.float32, device=query.device),
        torch.zeros((num_kv, group, s, head_dim), dtype=torch.float32, device=query.device),
    )
    # the cache < cache_len, then the chunk's own keys, causal and valid
    state = phase(key_cache, value_cache, lambda col: col < cache_len, state, k_scale, v_scale)
    _, l, acc = phase(
        key_new, value_new, lambda col: (col <= qi) & ((col < valid_len) | (col == qi)), state
    )
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    return out.reshape(num_heads, s, head_dim).to(query.dtype)


def decode_attention_appendfree(
    query: torch.Tensor,  # [H, 1, D]
    key_cache: torch.Tensor,  # [KV, budget, D] (new token NOT yet appended)
    value_cache: torch.Tensor,
    cache_len,  # int or 0-d int tensor — valid cached tokens
    key_new: torch.Tensor,  # [KV, 1, D] the current token's key
    value_new: torch.Tensor,
    k_scale=None,  # [KV, budget] f32 (int8 cache)
    v_scale=None,
) -> torch.Tensor:
    """Single-token attention without copying the cache: the new token's
    logit/value contribution is computed separately and merged into one
    softmax, so the cache is read once and never concatenated. An int8
    cache streams into the products with its scales commuted."""
    num_heads, _, head_dim = query.shape
    num_kv, budget, _ = key_cache.shape
    group = num_heads // num_kv
    q = _f32(query).reshape(num_kv, group, head_dim)
    scale = 1.0 / torch.sqrt(torch.tensor(float(head_dim), dtype=torch.float32))

    logits_c = torch.matmul(q, _f32(key_cache).transpose(-1, -2)) * scale
    if k_scale is not None:
        logits_c = logits_c * k_scale[:, None, :]
    live = torch.arange(budget, device=query.device) < cache_len
    logits_c = torch.where(live[None, None, :], logits_c, NEG_INF)  # [KV, G, T]
    logit_s = torch.matmul(q, _f32(key_new[:, 0])[:, :, None]) * scale  # [KV, G, 1]

    m = torch.maximum(logits_c.amax(dim=-1, keepdim=True), logit_s)
    p_c = torch.exp(logits_c - m)
    p_s = torch.exp(logit_s - m)
    denom = p_c.sum(dim=-1, keepdim=True) + p_s
    if v_scale is not None:
        p_c = p_c * v_scale[:, None, :]
    out = (
        torch.matmul(_f32(p_c.to(query.dtype)), _f32(value_cache))
        + p_s * _f32(value_new[:, 0])[:, None, :]
    ) / denom
    return out.reshape(num_heads, 1, head_dim).to(query.dtype)


def decode_attention_batch_gapped(
    query: torch.Tensor,  # [B, H, D]
    key_cache: torch.Tensor,  # [B, KV, S, D], or [L, B, KV, S, D] with ``layer``
    value_cache: torch.Tensor,
    final_len: torch.Tensor,  # [B] int32 — valid prefill tokens per slot
    gap_start,  # int — batch-uniform decode-region base column
    gap_filled,  # int — decode tokens already written
    key_new: torch.Tensor,  # [B, KV, D] the current token's key
    value_new: torch.Tensor,  # [B, KV, D]
    k_scale=None,  # [B, KV, S] f32 (int8 cache), [L, B, KV, S] with ``layer``
    v_scale=None,
    dec_start=None,  # [B] int32 per-slot decode-region start; None = gap_start
    layer=None,  # int: index the layer of a stacked cache (a free view here)
    impl: str = "xla",  # "pallas": K4 + append-free merge; "xla": plain softmax
) -> torch.Tensor:
    """Batched single-token attention over gap-layout caches.

    Every slot's decode tokens are written at the shared column
    ``gap_start + step``, so a slot's live keys are ``[0, final_len[b])``
    (its prefill) and ``[dec_start[b], gap_start + gap_filled)`` (its own
    decode region); the columns between are masked. The current token's
    key/value merge into the same softmax without being appended, as in
    ``decode_attention_appendfree``. An int8 cache comes with its per-key
    scales, which are commuted onto the logit and probability rows.
    Returns [B, H, D] in the query dtype.
    """
    if impl not in ("xla", "pallas"):
        raise ValueError(f"impl must be 'xla' or 'pallas', got {impl!r}")
    int8 = key_cache.dtype == torch.int8
    if (k_scale is None) != (v_scale is None) or int8 != (k_scale is not None):
        raise ValueError("an int8 cache needs k_scale and v_scale, and only an int8 cache takes them")
    if layer is not None:
        key_cache, value_cache = key_cache[layer], value_cache[layer]
        if int8:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    b, num_heads, head_dim = query.shape
    num_kv, s = key_cache.shape[1], key_cache.shape[2]
    group = num_heads // num_kv
    q = query.reshape(b, num_kv, group, head_dim)
    scale = 1.0 / torch.sqrt(torch.tensor(float(head_dim), dtype=torch.float32))
    dec0 = torch.full_like(final_len, gap_start) if dec_start is None else dec_start
    write_end = gap_start + gap_filled
    logit_s = torch.einsum("bkgd,bkd->bkg", _f32(q), _f32(key_new)) * scale

    if impl == "pallas":
        acc, m, l = decode_gapped.decode_gapped_flash_state(
            q.contiguous(), key_cache, value_cache, final_len, dec0, write_end, k_scale, v_scale
        )
        m2 = torch.maximum(m, logit_s)
        w_acc = torch.exp(m - m2)[..., None]
        w_s = torch.exp(logit_s - m2)[..., None]
        out = (acc * w_acc + w_s * _f32(value_new)[:, :, None, :]) / (l[..., None] * w_acc + w_s)
        return out.reshape(b, num_heads, head_dim).to(query.dtype)

    valid = decode_gapped.live_columns(s, final_len, dec0, write_end, query.device)
    logits_c = torch.matmul(_f32(q), _f32(key_cache).transpose(-1, -2)) * scale
    if int8:
        logits_c = logits_c * k_scale[:, :, None, :]
    logits_c = torch.where(valid[:, None, None, :], logits_c, NEG_INF)  # [B, KV, G, S]
    logit_s = logit_s[..., None]
    m = torch.maximum(logits_c.amax(dim=-1, keepdim=True), logit_s)
    p_c = torch.exp(logits_c - m)
    p_s = torch.exp(logit_s - m)
    denom = p_c.sum(dim=-1, keepdim=True) + p_s
    if int8:
        p_c = p_c * v_scale[:, :, None, :]
    out = (
        torch.matmul(_f32(p_c.to(query.dtype)), _f32(value_cache))
        + p_s * _f32(value_new)[:, :, None, :]
    ) / denom
    return out.reshape(b, num_heads, head_dim).to(query.dtype)
