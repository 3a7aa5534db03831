"""Static-budget KV cache for chunked prefill with PivotKV compression
(port of ``retake_tpu/runtime/cache.py``).

  k, v    : [layers, kv_heads, budget, head_dim]  rotated keys / values
                                                  (bf16, or int8)
  pos     : [layers, 3, budget] int32             per-layer position ids of
                                                  the cached tokens
  length  : 0-d int32 device tensor               valid tokens (same for
                                                  every layer)
  k_scale, v_scale : [layers, kv_heads, budget] f32, int8 mode only
                     (``kv_cache_dtype: int8``): the per-key symmetric
                     scales (``ops/quantization.quantize_kv_block``)

Unlike the JAX cache, which is immutable and rebuilt on every append, this
one is written IN PLACE: ``append_blocks`` (and the decoder, layer by layer)
copy each chunk's blocks into the preallocated buffers at offset ``length``
and then advance ``length``. ``length`` stays on the device so a chunk step
needs no host read; the kernels read it from device memory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from retake_tpu_torch.ops.quantization import quantize_kv_block


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None  # int8 mode; None = bf16 mode
    v_scale: Optional[torch.Tensor] = None

    @property
    def budget(self) -> int:
        return self.k.shape[2]

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_cache(
    num_layers: int,
    num_kv_heads: int,
    budget: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device=None,
    quantized: bool = False,
) -> KVCache:
    shape = (num_layers, num_kv_heads, budget, head_dim)
    kv_dtype = torch.int8 if quantized else dtype
    scales = (
        dict(k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
             v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device))
        if quantized else {}
    )
    return KVCache(
        k=torch.zeros(shape, dtype=kv_dtype, device=device),
        v=torch.zeros(shape, dtype=kv_dtype, device=device),
        pos=torch.zeros((num_layers, 3, budget), dtype=torch.int32, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
        **scales,
    )


def write_layer_block(
    cache: KVCache,
    layer: int,
    k_block: torch.Tensor,  # [kv_heads, S, head_dim] (int8 when scales are given)
    v_block: torch.Tensor,
    pos_block: torch.Tensor,  # [3, S]
    k_scales: Optional[torch.Tensor] = None,  # [kv_heads, S] f32: blocks already
    v_scales: Optional[torch.Tensor] = None,  #   quantized by the caller
) -> None:
    """Write one layer's chunk block at offset ``length`` (in place; the
    offset stays on the device). An int8 cache quantizes the blocks per
    key on the way in, unless the caller hands over blocks and scales it
    already quantized (the kernel prefill path's single rounding site)."""
    s = k_block.shape[1]
    idx = cache.length.to(torch.int64) + torch.arange(s, device=cache.k.device)
    if cache.quantized:
        if k_scales is None:
            k_block, k_scales = quantize_kv_block(k_block)
            v_block, v_scales = quantize_kv_block(v_block)
        cache.k_scale[layer].index_copy_(1, idx, k_scales)
        cache.v_scale[layer].index_copy_(1, idx, v_scales)
    cache.k[layer].index_copy_(1, idx, k_block.to(cache.k.dtype))
    cache.v[layer].index_copy_(1, idx, v_block.to(cache.v.dtype))
    cache.pos[layer].index_copy_(1, idx, pos_block.to(torch.int32))


def append_blocks(
    cache: KVCache,
    k_blocks: torch.Tensor,  # [layers, kv_heads, S, head_dim]
    v_blocks: torch.Tensor,
    pos_blocks: torch.Tensor,  # [layers, 3, S]
    advance,  # int or 0-d int tensor — valid_len (text) or keep_len (video)
    k_scales: Optional[torch.Tensor] = None,  # [layers, kv_heads, S] f32
    v_scales: Optional[torch.Tensor] = None,
) -> KVCache:
    """Write chunk blocks at offset ``length`` for every layer, then advance
    ``length`` (in place; returns the same cache)."""
    for layer in range(k_blocks.shape[0]):
        write_layer_block(
            cache, layer, k_blocks[layer], v_blocks[layer], pos_blocks[layer],
            None if k_scales is None else k_scales[layer],
            None if v_scales is None else v_scales[layer],
        )
    cache.length += advance
    return cache
