"""K1: chunked-prefill flash attention (CUDA kernel ``csrc/flash_prefill.cu``).

Replaces ``retake_tpu/ops/pallas/flash_prefill.py:flash_prefill_attention``
(bf16 mode; the int8-KV mode is not ported yet). Same contract as
``ops.attention.chunk_prefill_attention``, its plain twin: queries [H, S, D]
attend to the cache prefix ``< cache_len`` of [KV, budget, D] and causally
to the chunk's own keys [KV, S, D] (valid ``< valid_len``, plus the
diagonal). On CUDA, ``cache_len`` and ``valid_len`` are one-element int32
device tensors that the kernel reads itself.
"""

from __future__ import annotations

import torch

from retake_tpu_torch.ops import attention
from retake_tpu_torch.ops.cuda import _build, _checks

# the plain version of K1 (same masks, full materialized softmax)
flash_prefill_attention_plain = attention.chunk_prefill_attention

MAX_GROUP = 16  # query heads per KV head = warps per CTA (<= 512 threads)


def flash_prefill_attention(
    query: torch.Tensor,  # [H, S, D] RoPE'd chunk queries
    key_cache: torch.Tensor,  # [KV, budget, D]
    value_cache: torch.Tensor,
    cache_len,  # [1]/0-d int32 device tensor (int allowed on CPU)
    key_new: torch.Tensor,  # [KV, S, D]
    value_new: torch.Tensor,
    valid_len,
) -> torch.Tensor:
    if query.device.type == "cpu":
        return flash_prefill_attention_plain(
            query, key_cache, value_cache, cache_len, key_new, value_new, valid_len
        )
    name = "flash_prefill_attention"
    _checks.on_cuda(name, query, key_cache, value_cache, key_new, value_new)
    _checks.dtype(name, torch.bfloat16, query, key_cache, value_cache, key_new, value_new)
    h, s, d = query.shape
    kv, budget, _ = key_cache.shape
    if h % kv or h // kv > MAX_GROUP or d not in (64, 128):
        raise ValueError(f"{name}: unsupported heads {h}/{kv} or head_dim {d}")
    _checks.shape(name, value_cache, (kv, budget, d))
    _checks.shape(name, key_new, (kv, s, d))
    _checks.shape(name, value_new, (kv, s, d))
    cl = _checks.device_scalar(name, cache_len, query)
    vl = _checks.device_scalar(name, valid_len, query)
    out = torch.empty_like(query)
    rc = _build.library().retake_flash_prefill_bf16(
        query.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
        key_new.data_ptr(), value_new.data_ptr(), cl.data_ptr(), vl.data_ptr(),
        out.data_ptr(), kv, h // kv, s, budget, d, _build.stream_of(query),
    )
    _build.check(rc, name)
    flash_prefill_attention.launches += 1
    return out


flash_prefill_attention.launches = 0
