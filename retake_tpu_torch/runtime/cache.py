"""Static-budget KV cache for chunked prefill with PivotKV compression
(port of ``retake_tpu/runtime/cache.py``, bf16 mode).

  k, v  : [layers, kv_heads, budget, head_dim]   rotated keys / values
  pos   : [layers, 3, budget] int32              per-layer position ids of
                                                 the cached tokens
  length: 0-d int32 device tensor                valid tokens (same for every
                                                 layer)

Unlike the JAX cache, which is immutable and rebuilt on every append, this
one is written IN PLACE: ``append_blocks`` (and the decoder, layer by layer)
copy each chunk's blocks into the preallocated buffers at offset ``length``
and then advance ``length``. ``length`` stays on the device so a chunk step
needs no host read; the kernels read it from device memory. The int8 mode
is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    length: torch.Tensor

    @property
    def budget(self) -> int:
        return self.k.shape[2]

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]


def init_cache(
    num_layers: int,
    num_kv_heads: int,
    budget: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device=None,
) -> KVCache:
    shape = (num_layers, num_kv_heads, budget, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.zeros((num_layers, 3, budget), dtype=torch.int32, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def write_layer_block(
    cache: KVCache,
    layer: int,
    k_block: torch.Tensor,  # [kv_heads, S, head_dim]
    v_block: torch.Tensor,
    pos_block: torch.Tensor,  # [3, S]
) -> None:
    """Write one layer's chunk block at offset ``length`` (in place; the
    offset stays on the device)."""
    s = k_block.shape[1]
    idx = cache.length.to(torch.int64) + torch.arange(s, device=cache.k.device)
    cache.k[layer].index_copy_(1, idx, k_block.to(cache.k.dtype))
    cache.v[layer].index_copy_(1, idx, v_block.to(cache.v.dtype))
    cache.pos[layer].index_copy_(1, idx, pos_block.to(torch.int32))


def append_blocks(
    cache: KVCache,
    k_blocks: torch.Tensor,  # [layers, kv_heads, S, head_dim]
    v_blocks: torch.Tensor,
    pos_blocks: torch.Tensor,  # [layers, 3, S]
    advance,  # int or 0-d int tensor — valid_len (text) or keep_len (video)
) -> KVCache:
    """Write chunk blocks at offset ``length`` for every layer, then advance
    ``length`` (in place; returns the same cache)."""
    for layer in range(k_blocks.shape[0]):
        write_layer_block(cache, layer, k_blocks[layer], v_blocks[layer], pos_blocks[layer])
    cache.length += advance
    return cache
