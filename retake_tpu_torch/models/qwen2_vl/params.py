"""Qwen2-VL weights for the port: random init, the JAX weight bridge, and
the nested-parameter module (port of ``retake_tpu/models/qwen2_vl/params.py``).

The parameter tree keeps the JAX package's keys and layouts: linears are
input-major ``[in, out]`` and per-layer tensors are stacked ``[L, ...]``:

  embed_tokens [V, d]; layers/{input_ln, q, k, v, o, post_ln, gate, up, down};
  final_ln [d]; lm_head [d, V] (absent when tied);
  visual/{patch_embed, blocks/{ln1, qkv, proj, ln2, fc1, fc2},
          merger/{ln_q, fc1, fc2}}

As module parameters these keys become dotted names (``layers.q.w``).
Loading HF checkpoints is not ported yet.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig
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
) -> dict:
    """Random parameter tree (tests and benchmarks at reference geometry),
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``.
    Matrices are N(0, 1/fan_in), norms one, biases zero, the embedding
    N(0, 0.02^2), as in the JAX init (the draws themselves differ)."""
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

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {
        "input_ln": ones(l, d),
        "q": {"w": w(l, d, h * hd), "b": zeros(l, h * hd)},
        "k": {"w": w(l, d, kv * hd), "b": zeros(l, kv * hd)},
        "v": {"w": w(l, d, kv * hd), "b": zeros(l, kv * hd)},
        "o": {"w": w(l, h * hd, d)},
        "post_ln": ones(l, d),
        "gate": {"w": w(l, d, m)},
        "up": {"w": w(l, d, m)},
        "down": {"w": w(l, m, d)},
    }
    v = cfg.vision
    vd, vl, vm = v.embed_dim, v.depth, v.embed_dim * v.mlp_ratio
    merged = vd * v.spatial_merge_size**2
    visual = {
        "patch_embed": {"w": w(v.patch_input_dim, vd)},
        "blocks": {
            "ln1": {"scale": ones(vl, vd), "bias": zeros(vl, vd)},
            "qkv": {"w": w(vl, vd, 3 * vd), "b": zeros(vl, 3 * vd)},
            "proj": {"w": w(vl, vd, vd), "b": zeros(vl, vd)},
            "ln2": {"scale": ones(vl, vd), "bias": zeros(vl, vd)},
            "fc1": {"w": w(vl, vd, vm), "b": zeros(vl, vm)},
            "fc2": {"w": w(vl, vm, vd), "b": zeros(vl, vd)},
        },
        "merger": {
            "ln_q": {"scale": ones(vd), "bias": zeros(vd)},
            "fc1": {"w": w(merged, merged), "b": zeros(merged)},
            "fc2": {"w": w(merged, v.hidden_size), "b": zeros(v.hidden_size)},
        },
    }
    params = {
        "embed_tokens": w(cfg.vocab_size, d, scale=0.02),
        "layers": layers,
        "final_ln": ones(d),
        "visual": visual,
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w(d, cfg.vocab_size)
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
    layouts. ``dtype`` None keeps each leaf's dtype."""
    return {
        k: from_jax_params(v, dtype, device)
        if isinstance(v, dict)
        else _leaf_to_torch(v, dtype, device)
        for k, v in tree.items()
    }


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

    def layer(self, i: int) -> dict:
        """Views of layer ``i`` of a stacked [L, ...] tree, as a plain dict."""
        out = {name: p[i] for name, p in self._parameters.items()}
        out.update({name: m.layer(i) for name, m in self._modules.items()})
        return out
