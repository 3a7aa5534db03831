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
* ``decode_step_batch`` runs one token for B slots of the gap-layout cache
  ``[L, B, KV, S, D]``; its ``"pallas"`` attention is K4
  (``ops/cuda/decode_gapped.py``), ``"xla"`` the masked full-bucket softmax.
* int8: linears dispatch on int8 weights (``ops/quantization.qlinear``;
  ``act_quant`` = W8A8, prefill only: q/k/v and gate/up share one
  activation quantization). With an int8 KV cache the ``"pallas"`` prefill
  quantizes the chunk's k/v once and the same int8 blocks feed K1 and the
  cache append (one rounding site); the ``"xla"`` arm attends with bf16
  chunk keys and quantizes them at the append, as the JAX module does.
  The embedding and LM head may be int8 too.

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
from retake_tpu_torch.ops import quantization as q8
from retake_tpu_torch.ops.cuda import flash_prefill, pivot_scores
from retake_tpu_torch.runtime.cache import KVCache, write_layer_block


def _leaf(x):
    """A parameter, or an int8 ``{'w', 'scale'}`` pair as a ParamTree."""
    if isinstance(x, dict):
        return ParamTree(x)
    return nn.Parameter(x, requires_grad=False)


class TextDecoder(nn.Module):
    """Embedding, stacked decoder layers and LM head under the JAX keys
    ``embed_tokens``, ``layers``, ``final_ln`` and (untied) ``lm_head``;
    ``embed_tokens`` and ``lm_head`` are int8 ``{'w', 'scale'}`` pairs after
    ``quantize_llm_int8``. int8 linear weights are stored column-major
    (``ops/quantization.col_major_int8``); the embedding stays row-major, it
    is read by rows."""

    def __init__(self, cfg: Qwen2VLConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = _leaf(params["embed_tokens"])
        self.layers = ParamTree(q8.col_major_int8(params["layers"]))
        self.final_ln = nn.Parameter(params["final_ln"], requires_grad=False)
        self.lm_head = None
        if "lm_head" in params:
            head = params["lm_head"]
            self.lm_head = _leaf(q8.col_major_int8(head) if isinstance(head, dict) else head)

    @property
    def int8(self) -> bool:
        """Are the decoder linears int8 (``quantize_llm_int8``)?"""
        return "scale" in self.layers.q


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    return weight * normed


def _shared_quant_linears(x, lps, act_int8):
    """Several linears off the same input: under W8A8 the activation is
    quantized once and shared (q/k/v, gate/up)."""
    if not act_int8:
        return [q8.qlinear(x, lp) for lp in lps]
    xq, xs = q8.quantize_acts(x)
    outs = []
    for lp in lps:
        y = q8.int8_matmul_prequant(xq, xs, lp["w"], lp["scale"], x.dtype)
        b = lp.get("b")
        outs.append(y if b is None else y + b)
    return outs


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


def _layer_qkv(cfg, lp, hidden, cos, sin, act_quant=False):
    """Norm -> q/k/v projections -> RoPE; returns [H, N, D] heads."""
    x = rms_norm(hidden, lp["input_ln"], cfg.rms_norm_eps)
    q, k, v = _shared_quant_linears(x, (lp["q"], lp["k"], lp["v"]), act_quant)
    q = _heads(q, cfg.num_attention_heads, cfg.head_dim)
    k = _heads(k, cfg.num_key_value_heads, cfg.head_dim)
    v = _heads(v, cfg.num_key_value_heads, cfg.head_dim)
    return rope.apply_rope(q, cos, sin), rope.apply_rope(k, cos, sin), v


def _layer_out_mlp(cfg, lp, hidden, attn_flat, act_quant=False):
    """o-projection residual + SwiGLU MLP."""
    hidden = hidden + q8.qlinear(attn_flat, lp["o"], act_quant)
    x2 = rms_norm(hidden, lp["post_ln"], cfg.rms_norm_eps)
    gate, up = _shared_quant_linears(x2, (lp["gate"], lp["up"]), act_quant)
    return hidden + q8.qlinear(gate * torch.sigmoid(gate) * up, lp["down"], act_quant)


def _layer(
    cfg: Qwen2VLConfig,
    inv_freq: torch.Tensor,
    attention_scaling: float,
    compress: bool,
    reforge: bool,
    attn_impl: str,
    act_quant: bool,
    lp: dict,
    hidden: torch.Tensor,  # [S, d]
    pos3: torch.Tensor,  # [3, S] int32
    valid_len: torch.Tensor,  # 0-d int32
    keypatch,  # [S] bool or None
    keep_len: torch.Tensor,  # 0-d int32
    cache_len: torch.Tensor,  # 0-d int32
    ck: torch.Tensor,  # [KV, budget, D] (int8 with cks)
    cv: torch.Tensor,
    cpos: torch.Tensor,  # [3, budget]
    cks=None,  # [KV, budget] f32 scales of an int8 cache
    cvs=None,
):
    """One decoder layer over one chunk; returns (hidden, (k, v, pos, k
    scales, v scales) block); the scales are None unless the blocks are
    already int8."""
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
    q_rot, k_rot, v = _layer_qkv(cfg, lp, hidden, cos, sin, act_quant)

    if compress:
        if reforge:  # PivotKV scores de-rotated q/k (bf16 round trip)
            q_s = rope.apply_rope(q_rot, cos, sin, reverse=True, attention_scaling=attention_scaling)
            k_s = rope.apply_rope(k_rot, cos, sin, reverse=True, attention_scaling=attention_scaling)
        else:
            q_s, k_s = q_rot, k_rot

    # int8 cache, kernel prefill: the chunk's k/v are quantized once here;
    # the same int8 blocks feed K1 and the cache append (one rounding site)
    kq = ksc = vq = vsc = None
    if cks is not None and attn_impl == "pallas" and s > 1:
        kq, ksc = q8.quantize_kv_block(k_rot)
        vq, vsc = q8.quantize_kv_block(v)

    fused_scores = None
    if s == 1:
        if attn_impl == "xla":
            attn_out = attn_ops.chunk_prefill_attention(
                q_rot, ck, cv, cache_len, k_rot, v, valid_len, cks, cvs
            )
        else:  # append-free single-token attention (no cache copy)
            attn_out = attn_ops.decode_attention_appendfree(
                q_rot, ck, cv, cache_len, k_rot, v, cks, cvs
            )
    elif attn_impl == "pallas":
        attn_out = flash_prefill.flash_prefill_attention(
            q_rot, ck, cv, cache_len, k_rot if kq is None else kq, v if vq is None else vq,
            valid_len, cks, cvs, None if kq is None else (ksc, vsc),
        )
        if compress:
            sums = pivot_scores.pivot_score_sums(q_s, k_s, valid_len)
            fused_scores = sums.sum(dim=0) / (kv_heads * (n_heads // kv_heads))
    else:
        attn_out = attn_ops.chunk_prefill_attention(
            q_rot, ck, cv, cache_len, k_rot, v, valid_len, cks, cvs
        )
    hidden = _layer_out_mlp(cfg, lp, hidden, _unheads(attn_out), act_quant)

    if not compress:
        if kq is not None:
            return hidden, (kq, vq, pos_layer, ksc, vsc)
        return hidden, (k_rot, v, pos_layer, None, None)
    valid_mask = torch.arange(s, device=hidden.device) < valid_len
    if fused_scores is not None:  # keypatch force-keep + padding masking
        scores = fused_scores
        if keypatch is not None:
            scores = torch.where(keypatch, 1.0, scores)
        scores = torch.where(valid_mask, scores, pivotkv.NEG_INF)
    else:
        scores = pivotkv.eviction_scores(q_s, k_s, valid_mask, keypatch)
    perm, kept_mask = pivotkv.keep_partition(scores, keep_len)
    # per-key scales: quantize-then-permute == permute-then-quantize
    v_block, vs_block = (v[:, perm], None) if vq is None else (vq[:, perm], vsc[:, perm])
    pos_block = pos_layer[:, perm]
    if not reforge:
        if kq is None:
            return hidden, (k_rot[:, perm], v_block, pos_block, None, vs_block)
        return hidden, (kq[:, perm], v_block, pos_block, ksc[:, perm], vs_block)
    pos_block[0] = pivotkv.rescale_temporal_positions(
        pos_block[0], kept_mask, keep_len, valid_len
    )
    cos_c, sin_c = _mrope_tables(cfg, inv_freq, pos_block, attention_scaling, hidden.dtype)
    k_block = rope.apply_rope(k_s[:, perm], cos_c, sin_c)
    ks_block = None
    if kq is not None:  # reforge rewrote the keys: a new quantization of new data
        k_block, ks_block = q8.quantize_kv_block(k_block)
    return hidden, (k_block, v_block, pos_block, ks_block, vs_block)


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
    act_quant: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """Run one chunk through all layers; returns (hidden_out, cache). The
    cache is updated in place: each layer's block is written at offset
    ``length``, then ``length`` advances by keep_len (compress) or
    valid_len. ``act_quant``: W8A8 linears (int8 weights required)."""
    if attn_impl not in ("xla", "pallas"):
        raise NotImplementedError(f"attn_impl {attn_impl!r}")
    dev = hidden.device
    inv_freq, attention_scaling = _inv_freq(cfg, str(dev))
    valid_len = _device_int(valid_len, dev)
    keep_len = _device_int(keep_len, dev)
    pos3 = pos3.to(torch.int32)
    quantized = cache.quantized
    for i in range(cfg.num_hidden_layers):
        hidden, blocks = _layer(
            cfg, inv_freq, attention_scaling, compress, reforge, attn_impl, act_quant,
            model.layers.layer(i), hidden, pos3, valid_len, keypatch, keep_len,
            cache.length, cache.k[i], cache.v[i], cache.pos[i],
            cache.k_scale[i] if quantized else None, cache.v_scale[i] if quantized else None,
        )
        write_layer_block(cache, i, *blocks)
    cache.length += keep_len if compress else valid_len
    return hidden, cache


def _head_logits(model: TextDecoder, h: torch.Tensor) -> torch.Tensor:
    """LM head on normed hidden states [.., d] -> fp32 [.., V]. An int8 head
    is a weight-only linear; a tied int8 embedding's per-row scale becomes
    a per-logit scale."""
    head = model.lm_head
    if isinstance(head, ParamTree):
        logits = q8.qlinear(h, head.as_dict())
    elif head is not None:
        logits = h @ head
    elif isinstance(model.embed_tokens, ParamTree):
        e = model.embed_tokens
        logits = (h @ e.w.T.to(h.dtype)) * e.scale.to(h.dtype)
    else:
        logits = h @ model.embed_tokens.T
    return logits.to(torch.float32)


def final_logits(model: TextDecoder, cfg: Qwen2VLConfig, hidden_last: torch.Tensor):
    """Final RMSNorm + LM head on one token's hidden state [d] -> fp32 [V]."""
    h = rms_norm(hidden_last[None, :], model.final_ln, cfg.rms_norm_eps)[0]
    return _head_logits(model, h)


def embed(model: TextDecoder, token_ids: torch.Tensor) -> torch.Tensor:
    e = model.embed_tokens
    if isinstance(e, ParamTree):  # int8 rows times their scale, in the model dtype
        dtype = model.final_ln.dtype
        return e.w[token_ids].to(dtype) * e.scale[token_ids][:, None].to(dtype)
    return e[token_ids]


def decode_step_batch(
    model: TextDecoder,
    cfg: Qwen2VLConfig,
    k_all: torch.Tensor,  # [L, B, KV, S, D] batched gap-layout key cache (int8 with ks_all)
    v_all: torch.Tensor,
    hidden: torch.Tensor,  # [B, d] current-token embeddings
    base_t: torch.Tensor,  # [L, B] int32 per-layer temporal position base
    pos_rest: torch.Tensor,  # [B] int32 — M-RoPE rows 1/2 position this step
    final_len: torch.Tensor,  # [B] int32 prefill lengths
    gap_start: int,  # uniform decode-region base column
    gap_filled: int,  # decode steps already written
    dec_start=None,  # [B] int32 per-slot decode-region start; None = gap_start
    attn_impl: str = "xla",  # "pallas": K4; "xla": full-bucket masked softmax
    ks_all=None,  # [L, B, KV, S] f32 scales of an int8 cache
    vs_all=None,
):
    """One batched decode step; the batch axis stands in for the token axis
    of ``_layer_qkv`` / ``_layer_out_mlp``, so the per-layer numerics are the
    sequential path's. Positions continue analytically: layer l's temporal
    row is ``base_t[l] + gap_filled`` and rows 1/2 are ``pos_rest``. Reads
    the caches only; returns (hidden [B, d], k_blocks [L, B, KV, D],
    v_blocks), unquantized, for the caller to write at column ``gap_start +
    gap_filled``. int8 weights run weight-only: decode is never W8A8."""
    inv_freq, attention_scaling = _inv_freq(cfg, str(hidden.device))
    b = hidden.shape[0]
    k_blocks, v_blocks = [], []
    for i in range(cfg.num_hidden_layers):
        lp = model.layers.layer(i)
        pos3 = torch.stack([base_t[i] + gap_filled, pos_rest, pos_rest]).to(torch.int32)
        cos, sin = _mrope_tables(cfg, inv_freq, pos3, attention_scaling, hidden.dtype)
        q_rot, k_rot, v = _layer_qkv(cfg, lp, hidden, cos, sin)  # [H, B, D]
        k_b, v_b = k_rot.transpose(0, 1), v.transpose(0, 1)  # [B, KV, D]
        attn = attn_ops.decode_attention_batch_gapped(
            q_rot.transpose(0, 1), k_all[i], v_all[i], final_len, gap_start,
            gap_filled, k_b, v_b,
            None if ks_all is None else ks_all[i], None if vs_all is None else vs_all[i],
            dec_start=dec_start, impl=attn_impl,
        )  # [B, H, D]
        hidden = _layer_out_mlp(cfg, lp, hidden, attn.reshape(b, -1))
        k_blocks.append(k_b)
        v_blocks.append(v_b)
    return hidden, torch.stack(k_blocks), torch.stack(v_blocks)


def final_logits_batch(model: TextDecoder, cfg: Qwen2VLConfig, hidden: torch.Tensor):
    """Final RMSNorm + LM head on a batch of hidden states [B, d] -> fp32 [B, V]."""
    return _head_logits(model, rms_norm(hidden, model.final_ln, cfg.rms_norm_eps))
