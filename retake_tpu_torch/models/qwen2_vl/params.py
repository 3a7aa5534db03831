"""Qwen2-VL weights for the port: random init, the JAX weight bridge, and
the nested-parameter module (port of ``retake_tpu/models/qwen2_vl/params.py``).

The parameter tree keeps the JAX package's keys and layouts: linears are
input-major ``[in, out]`` and per-layer tensors are stacked ``[L, ...]``:

  embed_tokens [V, d]; layers/{input_ln, q, k, v, o, post_ln, gate, up, down};
  final_ln [d]; lm_head [d, V] (absent when tied);
  visual/{patch_embed, blocks/{ln1, qkv, proj, ln2, fc1, fc2},
          merger/{ln_q, fc1, fc2}}

As module parameters these keys become dotted names (``layers.q.w``).
An int8 linear is ``{'w': int8, 'scale': f32}`` (``ops/quantization.py``),
and so is a quantized ``embed_tokens`` (per-row scale) or ``lm_head``.
Loading HF checkpoints is not ported yet.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig
from retake_tpu_torch.ops import quantization as q8
from retake_tpu_torch.ops import rope


def rope_params(cfg: Qwen2VLConfig) -> Tuple[np.ndarray, float]:
    """(inv_freq ndarray, attention_scaling) honoring YaRN."""
    if cfg.yarn_factor is None or cfg.yarn_factor <= 1.0:
        return rope.default_inv_freq(cfg.head_dim, cfg.rope_theta), 1.0
    return rope.yarn_inv_freq(
        cfg.head_dim,
        cfg.rope_theta,
        cfg.yarn_factor,
        cfg.max_position_embeddings,
        cfg.yarn_beta_fast,
        cfg.yarn_beta_slow,
    )


def init_params(
    cfg: Qwen2VLConfig,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    device="cpu",
    quantize_int8: bool = False,
    quantize_vit_int8: bool = False,
) -> dict:
    """Random parameter tree (tests and benchmarks at reference geometry),
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``.
    Matrices are N(0, 1/fan_in), norms one, biases zero, the embedding
    N(0, 0.02^2), as in the JAX init (the draws themselves differ).

    ``quantize_int8`` quantizes the decoder linears, the embedding and the
    LM head, ``quantize_vit_int8`` the vision block and merger linears,
    each stack right after it is drawn, on ``device``: the full bf16 tree
    (16.6 GB at 7B) never exists, one bf16 stack at a time does. The result
    equals ``quantize_llm_int8`` / ``quantize_vit_int8`` of the unquantized
    tree of the same seed, leaf for leaf."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, m, l = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    h, kv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def w(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(
            shape[-2] if len(shape) > 1 else shape[-1]
        )
        x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return x * torch.tensor(scale, dtype=dtype)

    def qw(*shape):  # a decoder linear
        x = w(*shape)
        return q8.quantize_linear_stack(x) if quantize_int8 else {"w": x}

    def vqw(*shape):  # a vision block / merger linear
        x = w(*shape)
        return q8.quantize_linear_stack(x) if quantize_vit_int8 else {"w": x}

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "input_ln": ones(l, d),
        "q": {**qw(l, d, h * hd), "b": zeros(l, h * hd)},
        "k": {**qw(l, d, kv * hd), "b": zeros(l, kv * hd)},
        "v": {**qw(l, d, kv * hd), "b": zeros(l, kv * hd)},
        "o": qw(l, h * hd, d),
        "post_ln": ones(l, d),
        "gate": qw(l, d, m),
        "up": qw(l, d, m),
        "down": qw(l, m, d),
    }
    v = cfg.vision
    vd, vl, vm = v.embed_dim, v.depth, v.embed_dim * v.mlp_ratio
    merged = vd * v.spatial_merge_size**2
    visual = {
        "patch_embed": {"w": w(v.patch_input_dim, vd)},
        "blocks": {
            "ln1": {"scale": ones(vl, vd), "bias": zeros(vl, vd)},
            "qkv": {**vqw(vl, vd, 3 * vd), "b": zeros(vl, 3 * vd)},
            "proj": {**vqw(vl, vd, vd), "b": zeros(vl, vd)},
            "ln2": {"scale": ones(vl, vd), "bias": zeros(vl, vd)},
            "fc1": {**vqw(vl, vd, vm), "b": zeros(vl, vm)},
            "fc2": {**vqw(vl, vm, vd), "b": zeros(vl, vd)},
        },
        "merger": {
            "ln_q": {"scale": ones(vd), "bias": zeros(vd)},
            "fc1": {**vqw(merged, merged), "b": zeros(merged)},
            "fc2": {**vqw(merged, v.hidden_size), "b": zeros(v.hidden_size)},
        },
    }
    embed = w(cfg.vocab_size, d, scale=0.02)
    params = {
        "embed_tokens": q8.quantize_embedding(embed) if quantize_int8 else embed,
        "layers": layers,
        "final_ln": ones(d),
        "visual": visual,
    }
    del embed
    if not cfg.tie_word_embeddings:
        head = w(d, cfg.vocab_size)
        params["lm_head"] = q8.quantize_weight(head) if quantize_int8 else head
    return params


def _leaf_to_torch(x, dtype, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        t = torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def from_jax_params(tree: dict, dtype: torch.dtype | None = None, device="cpu") -> dict:
    """The weight bridge: the JAX package's parameter pytree (leaves as
    numpy or JAX arrays) -> the port's tree of tensors, same keys and
    layouts. ``dtype`` casts the floating leaves (None keeps each leaf's
    dtype); int8 weights and the fp32 scales beside them are carried as
    they are, as the JAX package keeps them in a bf16 model."""
    quantized = np.asarray(tree.get("w", np.zeros(0))).dtype == np.int8
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = from_jax_params(v, dtype, device)
            continue
        kind = np.asarray(v).dtype
        floating = kind.kind == "f" or kind.name == "bfloat16"
        keep = (quantized and k == "scale") or not floating
        out[k] = _leaf_to_torch(v, None if keep else dtype, device)
    return out


class ParamTree(nn.Module):
    """A nested parameter dict as a module: dict keys become submodule and
    parameter names. Inference only (``requires_grad=False``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def as_dict(self) -> dict:
        """The (unstacked) parameters as a plain nested dict."""
        out = dict(self._parameters)
        out.update({name: m.as_dict() for name, m in self._modules.items()})
        return out

    def layer(self, i: int) -> dict:
        """Views of layer ``i`` of a stacked [L, ...] tree, as a plain dict."""
        out = {name: p[i] for name, p in self._parameters.items()}
        out.update({name: m.layer(i) for name, m in self._modules.items()})
        return out
