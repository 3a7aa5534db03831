"""K1: chunked-prefill flash attention (CUDA kernel ``csrc/flash_prefill.cu``).

Replaces ``retake_tpu/ops/pallas/flash_prefill.py:flash_prefill_attention``
in both its modes. Same contract as ``ops.attention.chunk_prefill_attention``:
queries [H, S, D] attend to the cache prefix ``< cache_len`` of [KV, budget,
D] and causally to the chunk's own keys [KV, S, D] (valid ``< valid_len``,
plus the diagonal). On CUDA, ``cache_len`` and ``valid_len`` are
one-element int32 device tensors that the kernel reads itself.

int8-KV mode (``k_scale`` / ``v_scale`` [KV, budget] f32 given): the cache
is int8 with per-key scales, and so is the chunk: ``new_scales`` ([KV, S],
[KV, S]) marks ``key_new`` / ``value_new`` as already int8 (the decoder's
single rounding site); without it the bf16 chunk is quantized here, as the
TPU kernel does. Every key and value row is dequantized to
``bf16(f32(x) * s)`` before the products (the TPU kernel's numerics). This
mode launches ``flash_prefill_attention_int8`` and counts there.

The kernel's launch plan is fixed by its constants (``BQ``, ``BK``,
``STAGES``, ``OPS8``): ``launch_plan`` states it as a plain function, which
the wrapper uses to refuse shapes the kernel does not take and the CPU tests
check. BQ = 128 and 4 ring stages were kept by measurement (``PERF.md``).
"""

from __future__ import annotations

import torch

from retake_tpu_torch.ops import attention
from retake_tpu_torch.ops.cuda import _build, _checks
from retake_tpu_torch.ops.quantization import quantize_kv_block

BK = 64  # keys per K/V tile
BQ = 128  # query rows per CTA: 64 per consumer warpgroup
STAGES = 4  # K/V tiles in flight in the TMA ring
OPS8 = 3  # int8 mode: dequantized bf16 operand tiles in flight


def launch_plan(heads: int, num_kv: int, s: int, d: int, int8: bool) -> dict:
    """Grid, block and dynamic shared memory of one K1 launch, as the
    kernel's launcher sets them: one CTA per (query head, block of BQ query
    rows), head index fastest; two consumer warpgroups and one producer
    warpgroup (two in int8 mode, where the producers also dequantize).
    Shared memory (the kernel's ``layout``): 1024 bytes of alignment slack,
    the Q block, the K|V tiles and the mbarriers; bf16: STAGES operand tiles
    with full / empty barriers each; int8: STAGES int8 tiles (each rounded up
    to 1024 bytes, one barrier each) and OPS8 dequantized operand tiles."""
    if heads % num_kv or d not in (64, 128):
        raise ValueError(f"K1: unsupported heads {heads}/{num_kv} or head_dim {d}")
    operand = 2 * BK * d * 2
    if int8:
        smem = (1024 + BQ * d * 2 + STAGES * (-(-2 * BK * d // 1024) * 1024) + OPS8 * operand
                + 8 * (2 * OPS8 + 1 + STAGES))
    else:
        smem = 1024 + BQ * d * 2 + STAGES * operand + 8 * (2 * STAGES + 1)
    return dict(grid=(heads, -(-s // BQ)), block=128 * (BQ // 64 + (2 if int8 else 1)), bq=BQ,
                bk=BK, stages=STAGES, smem_bytes=smem)


def _chunk_int8(key_new, value_new, new_scales):
    """The chunk's int8 k/v and scales (quantized here unless given)."""
    if new_scales is not None:
        return key_new, value_new, new_scales[0], new_scales[1]
    kq, ks = quantize_kv_block(key_new)
    vq, vs = quantize_kv_block(value_new)
    return kq, vq, ks, vs


def flash_prefill_attention_plain(
    query, key_cache, value_cache, cache_len, key_new, value_new, valid_len,
    k_scale=None, v_scale=None, new_scales=None,
) -> torch.Tensor:
    """The plain version of K1: same masks, full materialized softmax; in
    int8 mode the cache and the chunk dequantized as the kernel does."""
    if k_scale is not None:
        kq, vq, ks, vs = _chunk_int8(key_new, value_new, new_scales)
        key_new = attention.dequantize_cache(kq, ks, query.dtype)
        value_new = attention.dequantize_cache(vq, vs, query.dtype)
    return attention.chunk_prefill_attention(
        query, key_cache, value_cache, cache_len, key_new, value_new, valid_len,
        k_scale, v_scale,
    )


def _check_common(name, query, key_cache, value_cache, key_new, value_new):
    _checks.on_cuda(name, query, key_cache, value_cache, key_new, value_new)
    _checks.dtype(name, torch.bfloat16, query)
    h, s, d = query.shape
    kv, budget, _ = key_cache.shape
    launch_plan(h, kv, s, d, False)  # refuses what the kernel does not take
    _checks.shape(name, value_cache, (kv, budget, d))
    _checks.shape(name, key_new, (kv, s, d))
    _checks.shape(name, value_new, (kv, s, d))
    for t in (query, key_cache, value_cache, key_new, value_new):
        if t.data_ptr() % 16:  # TMA reads from 16-byte-aligned addresses
            raise ValueError(f"{name}: tensors must start on a 16-byte boundary")
    return h, s, d, kv, budget


def flash_prefill_attention(
    query: torch.Tensor,  # [H, S, D] RoPE'd chunk queries
    key_cache: torch.Tensor,  # [KV, budget, D] (int8 with k_scale)
    value_cache: torch.Tensor,
    cache_len,  # [1]/0-d int32 device tensor (int allowed on CPU)
    key_new: torch.Tensor,  # [KV, S, D]
    value_new: torch.Tensor,
    valid_len,
    k_scale=None,  # [KV, budget] f32: int8-KV mode
    v_scale=None,
    new_scales=None,  # ([KV, S], [KV, S]) f32: key_new/value_new already int8
) -> torch.Tensor:
    if query.device.type == "cpu":
        return flash_prefill_attention_plain(
            query, key_cache, value_cache, cache_len, key_new, value_new, valid_len,
            k_scale, v_scale, new_scales,
        )
    if k_scale is not None:
        return flash_prefill_attention_int8(
            query, key_cache, value_cache, cache_len, key_new, value_new, valid_len,
            k_scale, v_scale, new_scales,
        )
    name = "flash_prefill_attention"
    h, s, d, kv, budget = _check_common(name, query, key_cache, value_cache, key_new, value_new)
    _checks.dtype(name, torch.bfloat16, key_cache, value_cache, key_new, value_new)
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


def flash_prefill_attention_int8(
    query, key_cache, value_cache, cache_len, key_new, value_new, valid_len,
    k_scale, v_scale, new_scales=None,
) -> torch.Tensor:
    """K1's int8-KV mode on CUDA (see the module docstring)."""
    name = "flash_prefill_attention_int8"
    key_new, value_new, kn_scale, vn_scale = _chunk_int8(key_new, value_new, new_scales)
    h, s, d, kv, budget = _check_common(name, query, key_cache, value_cache, key_new, value_new)
    _checks.on_cuda(name, query, k_scale, v_scale, kn_scale, vn_scale)
    _checks.dtype(name, torch.int8, key_cache, value_cache, key_new, value_new)
    _checks.dtype(name, torch.float32, k_scale, v_scale, kn_scale, vn_scale)
    _checks.shape(name, k_scale, (kv, budget))
    _checks.shape(name, v_scale, (kv, budget))
    _checks.shape(name, kn_scale, (kv, s))
    _checks.shape(name, vn_scale, (kv, s))
    cl = _checks.device_scalar(name, cache_len, query)
    vl = _checks.device_scalar(name, valid_len, query)
    out = torch.empty_like(query)
    rc = _build.library().retake_flash_prefill_int8(
        query.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
        key_new.data_ptr(), value_new.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        kn_scale.data_ptr(), vn_scale.data_ptr(), cl.data_ptr(), vl.data_ptr(),
        out.data_ptr(), kv, h // kv, s, budget, d, _build.stream_of(query),
    )
    _build.check(rc, name)
    flash_prefill_attention_int8.launches += 1
    return out


flash_prefill_attention.launches = 0
flash_prefill_attention_int8.launches = 0
