"""Qwen2(-VL) text decoder: GQA + M-RoPE + PivotKV chunk step
(port of ``retake_tpu/models/qwen2_vl/text.py``).

* The JAX ``lax.scan`` over layers is a Python loop here; each layer writes
  its cache block in place (``runtime/cache.py``) right after it has read
  the cache, so later layers and chunks see the same values as in JAX.
* Each layer recomputes its own RoPE tables: after eviction, positions are
  per layer (the reference's discontinuity fix), so the chunk's temporal row
  is rebased to continue the layer's cached last temporal id + 1.
* Eviction produces a compaction permutation (ops/pivotkv.py) and the chunk
  writes one block per layer at the running cache offset.
* ``attn_impl="pallas"``: K1 (``ops/cuda/flash_prefill.py``) for chunk
  attention and K2 (``ops/cuda/pivot_scores.py``) for eviction scores, which
  launch the CUDA kernels on CUDA tensors; ``"xla"``: the plain torch path
  (masked full attention, ``pivotkv.eviction_scores``).

Numerics follow the JAX module: activations in the model dtype, fp32
RMSNorm statistics (normalize, cast, then scale), fp32 softmax, and the
rotate -> de-rotate -> re-rotate round trip under position reforge.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch import nn

from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig
from retake_tpu_torch.models.qwen2_vl.params import ParamTree, rope_params
from retake_tpu_torch.ops import attention as attn_ops
from retake_tpu_torch.ops import pivotkv, rope
from retake_tpu_torch.ops.cuda import flash_prefill, pivot_scores
from retake_tpu_torch.runtime.cache import KVCache, write_layer_block


class TextDecoder(nn.Module):
    """Embedding, stacked decoder layers and LM head under the JAX keys
    ``embed_tokens``, ``layers``, ``final_ln`` and (untied) ``lm_head``."""

    def __init__(self, cfg: Qwen2VLConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(params["embed_tokens"], requires_grad=False)
        self.layers = ParamTree(params["layers"])
        self.final_ln = nn.Parameter(params["final_ln"], requires_grad=False)
        self.lm_head = (
            nn.Parameter(params["lm_head"], requires_grad=False)
            if "lm_head" in params else None
        )


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    return weight * normed


def _linear(x, p):
    y = x @ p["w"]
    b = p.get("b")
    return y if b is None else y + b


def _heads(x: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """[S, H*D] -> contiguous [H, S, D]"""
    s = x.shape[0]
    return x.reshape(s, num_heads, head_dim).transpose(0, 1).contiguous()


def _unheads(x: torch.Tensor) -> torch.Tensor:
    """[H, S, D] -> [S, H*D]"""
    h, s, d = x.shape
    return x.transpose(0, 1).reshape(s, h * d)


@functools.lru_cache(maxsize=None)
def _inv_freq(cfg: Qwen2VLConfig, device: str) -> Tuple[torch.Tensor, float]:
    inv_freq, scaling = rope_params(cfg)
    return torch.from_numpy(inv_freq).to(device), scaling


def _mrope_tables(cfg, inv_freq, pos3, attention_scaling, dtype):
    """M-RoPE cos/sin [S, D] for positions [3, S]."""
    cos3, sin3 = rope.compute_cos_sin(inv_freq, pos3[:, None, :], attention_scaling, dtype)
    return (
        rope.select_mrope(cos3, cfg.mrope_section)[0],
        rope.select_mrope(sin3, cfg.mrope_section)[0],
    )


def _layer_qkv(cfg, lp, hidden, cos, sin):
    """Norm -> q/k/v projections -> RoPE; returns [H, N, D] heads."""
    x = rms_norm(hidden, lp["input_ln"], cfg.rms_norm_eps)
    q = _heads(_linear(x, lp["q"]), cfg.num_attention_heads, cfg.head_dim)
    k = _heads(_linear(x, lp["k"]), cfg.num_key_value_heads, cfg.head_dim)
    v = _heads(_linear(x, lp["v"]), cfg.num_key_value_heads, cfg.head_dim)
    return rope.apply_rope(q, cos, sin), rope.apply_rope(k, cos, sin), v


def _layer_out_mlp(cfg, lp, hidden, attn_flat):
    """o-projection residual + SwiGLU MLP."""
    hidden = hidden + _linear(attn_flat, lp["o"])
    x2 = rms_norm(hidden, lp["post_ln"], cfg.rms_norm_eps)
    gate = _linear(x2, lp["gate"])
    return hidden + _linear(gate * torch.sigmoid(gate) * _linear(x2, lp["up"]), lp["down"])


def _layer(
    cfg: Qwen2VLConfig,
    inv_freq: torch.Tensor,
    attention_scaling: float,
    compress: bool,
    reforge: bool,
    attn_impl: str,
    lp: dict,
    hidden: torch.Tensor,  # [S, d]
    pos3: torch.Tensor,  # [3, S] int32
    valid_len: torch.Tensor,  # 0-d int32
    keypatch,  # [S] bool or None
    keep_len: torch.Tensor,  # 0-d int32
    cache_len: torch.Tensor,  # 0-d int32
    ck: torch.Tensor,  # [KV, budget, D]
    cv: torch.Tensor,
    cpos: torch.Tensor,  # [3, budget]
):
    """One decoder layer over one chunk; returns (hidden, (k, v, pos) block)."""
    kv_heads, n_heads = cfg.num_key_value_heads, cfg.num_attention_heads
    s = hidden.shape[0]

    if reforge:  # continue this layer's cached temporal ids contiguously
        last = torch.clamp(cache_len - 1, min=0).to(torch.int64)
        prev_t = torch.where(cache_len > 0, cpos[0, last], -1)
        pos_layer = pos3.clone()
        pos_layer[0] += prev_t + 1 - pos3[0, 0]
    else:
        pos_layer = pos3
    cos, sin = _mrope_tables(cfg, inv_freq, pos_layer, attention_scaling, hidden.dtype)
    q_rot, k_rot, v = _layer_qkv(cfg, lp, hidden, cos, sin)

    if compress:
        if reforge:  # PivotKV scores de-rotated q/k (bf16 round trip)
            q_s = rope.apply_rope(q_rot, cos, sin, reverse=True, attention_scaling=attention_scaling)
            k_s = rope.apply_rope(k_rot, cos, sin, reverse=True, attention_scaling=attention_scaling)
        else:
            q_s, k_s = q_rot, k_rot

    fused_scores = None
    if s == 1:
        if attn_impl == "xla":
            attn_out = attn_ops.chunk_prefill_attention(
                q_rot, ck, cv, cache_len, k_rot, v, valid_len
            )
        else:  # append-free single-token attention (no cache copy)
            attn_out = attn_ops.decode_attention_appendfree(
                q_rot, ck, cv, cache_len, k_rot, v
            )
    elif attn_impl == "pallas":
        attn_out = flash_prefill.flash_prefill_attention(
            q_rot, ck, cv, cache_len, k_rot, v, valid_len
        )
        if compress:
            sums = pivot_scores.pivot_score_sums(q_s, k_s, valid_len)
            fused_scores = sums.sum(dim=0) / (kv_heads * (n_heads // kv_heads))
    else:
        attn_out = attn_ops.chunk_prefill_attention(
            q_rot, ck, cv, cache_len, k_rot, v, valid_len
        )
    hidden = _layer_out_mlp(cfg, lp, hidden, _unheads(attn_out))

    if not compress:
        return hidden, (k_rot, v, pos_layer)
    valid_mask = torch.arange(s, device=hidden.device) < valid_len
    if fused_scores is not None:  # keypatch force-keep + padding masking
        scores = fused_scores
        if keypatch is not None:
            scores = torch.where(keypatch, 1.0, scores)
        scores = torch.where(valid_mask, scores, pivotkv.NEG_INF)
    else:
        scores = pivotkv.eviction_scores(q_s, k_s, valid_mask, keypatch)
    perm, kept_mask = pivotkv.keep_partition(scores, keep_len)
    v_block = v[:, perm]
    pos_block = pos_layer[:, perm]
    if not reforge:
        return hidden, (k_rot[:, perm], v_block, pos_block)
    pos_block[0] = pivotkv.rescale_temporal_positions(
        pos_block[0], kept_mask, keep_len, valid_len
    )
    cos_c, sin_c = _mrope_tables(cfg, inv_freq, pos_block, attention_scaling, hidden.dtype)
    return hidden, (rope.apply_rope(k_s[:, perm], cos_c, sin_c), v_block, pos_block)


def _device_int(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.tensor(x, dtype=torch.int32, device=device)


def decoder_chunk(
    model: TextDecoder,
    cfg: Qwen2VLConfig,
    cache: KVCache,
    hidden: torch.Tensor,  # [S, d] chunk input embeddings
    pos3: torch.Tensor,  # [3, S] int32 global position ids
    valid_len,  # int or 0-d int32 tensor
    keypatch,  # [S] bool (ignored unless compress)
    keep_len,  # int or 0-d int32 tensor (ignored unless compress)
    compress: bool,
    reforge: bool,
    attn_impl: str = "xla",
) -> Tuple[torch.Tensor, KVCache]:
    """Run one chunk through all layers; returns (hidden_out, cache). The
    cache is updated in place: each layer's block is written at offset
    ``length``, then ``length`` advances by keep_len (compress) or
    valid_len."""
    if attn_impl not in ("xla", "pallas"):
        raise NotImplementedError(f"attn_impl {attn_impl!r}")
    dev = hidden.device
    inv_freq, attention_scaling = _inv_freq(cfg, str(dev))
    valid_len = _device_int(valid_len, dev)
    keep_len = _device_int(keep_len, dev)
    pos3 = pos3.to(torch.int32)
    for i in range(cfg.num_hidden_layers):
        hidden, (k_block, v_block, pos_block) = _layer(
            cfg, inv_freq, attention_scaling, compress, reforge, attn_impl,
            model.layers.layer(i), hidden, pos3, valid_len, keypatch, keep_len,
            cache.length, cache.k[i], cache.v[i], cache.pos[i],
        )
        write_layer_block(cache, i, k_block, v_block, pos_block)
    cache.length += keep_len if compress else valid_len
    return hidden, cache


def final_logits(model: TextDecoder, cfg: Qwen2VLConfig, hidden_last: torch.Tensor):
    """Final RMSNorm + LM head on one token's hidden state [d] -> fp32 [V]."""
    h = rms_norm(hidden_last[None, :], model.final_ln, cfg.rms_norm_eps)[0]
    head = model.lm_head if model.lm_head is not None else model.embed_tokens.T
    return (h @ head).to(torch.float32)


def embed(model: TextDecoder, token_ids: torch.Tensor) -> torch.Tensor:
    return model.embed_tokens[token_ids]
