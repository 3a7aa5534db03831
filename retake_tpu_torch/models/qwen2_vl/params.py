"""Qwen2-VL weights for the port: random init, HF checkpoint loading, the
JAX weight bridge, and the nested-parameter module (port of
``retake_tpu/models/qwen2_vl/params.py``).

The parameter tree keeps the JAX package's keys and layouts: linears are
input-major ``[in, out]`` and per-layer tensors are stacked ``[L, ...]``:

  embed_tokens [V, d]; layers/{input_ln, q, k, v, o, post_ln, gate, up, down};
  final_ln [d]; lm_head [d, V] (absent when tied);
  visual/{patch_embed, blocks/{ln1, qkv, proj, ln2, fc1, fc2},
          merger/{ln_q, fc1, fc2}}

As module parameters these keys become dotted names (``layers.q.w``).
An int8 linear is ``{'w': int8, 'scale': f32}`` (``ops/quantization.py``),
and so is a quantized ``embed_tokens`` (per-row scale) or ``lm_head``.

HF checkpoints (``from_hf_tensors``, ``load_safetensors``,
``from_torch_model``) map to this tree with the JAX loader's renames,
``[out, in] -> [in, out]`` transposes and layer stacking; the safetensors
loader reads one tensor at a time (``utils/safetensors_io.py``) and stacks
each layer group on the device in the target dtype.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from retake_tpu_torch import device as device_lib
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
    device="cuda",
    quantize_int8: bool = False,
    quantize_vit_int8: bool = False,
    vision: bool = True,
) -> dict:
    """Random parameter tree (tests and benchmarks at reference geometry),
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``;
    ``vision=False`` leaves out the Qwen2-VL ViT (the LLaVA text decoder).
    Matrices are N(0, 1/fan_in), norms one, biases zero, the embedding
    N(0, 0.02^2), as in the JAX init (the draws themselves differ).

    ``quantize_int8`` quantizes the decoder linears, the embedding and the
    LM head, ``quantize_vit_int8`` the vision block and merger linears,
    each stack right after it is drawn, on ``device``: the full bf16 tree
    (16.6 GB at 7B) never exists, one bf16 stack at a time does. The result
    equals ``quantize_llm_int8`` / ``quantize_vit_int8`` of the unquantized
    tree of the same seed, leaf for leaf."""
    device = device_lib.resolve(device)
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
    params = {"layers": layers, "final_ln": ones(d)}
    if vision:  # drawn before the embedding, as always
        params["visual"] = _init_vision(cfg, w, vqw, zeros, ones)
    embed = w(cfg.vocab_size, d, scale=0.02)
    params["embed_tokens"] = q8.quantize_embedding(embed) if quantize_int8 else embed
    del embed
    if not cfg.tie_word_embeddings:
        head = w(d, cfg.vocab_size)
        params["lm_head"] = q8.quantize_weight(head) if quantize_int8 else head
    return params


def _init_vision(cfg: Qwen2VLConfig, w, vqw, zeros, ones) -> dict:
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
    return visual


def _canonical(name: str) -> str:
    """Normalize HF parameter names across transformers versions."""
    name = re.sub(r"^model\.", "", name)
    name = re.sub(r"^language_model\.", "", name)
    name = re.sub(r"^visual\.", "visual.", name)
    return name


class HFLoader:
    """Reads HF tensors by name through ``get`` (host tensors, any dtype)
    and lays them out on ``device`` in ``dtype``, one stack at a time."""

    def __init__(self, get: Callable[[str], torch.Tensor], dtype, device):
        self.get, self.dtype, self.device = get, dtype, device

    def t(self, name: str) -> torch.Tensor:
        return torch.as_tensor(self.get(name)).to(device=self.device, dtype=self.dtype)

    def lin(self, name: str) -> torch.Tensor:  # torch Linear [out, in] -> [in, out]
        return self.t(name).transpose(-1, -2).contiguous()

    def stack(self, fmt: str, n: int) -> torch.Tensor:
        return torch.stack([self.t(fmt.format(i)) for i in range(n)])

    def stack_lin(self, fmt: str, n: int) -> torch.Tensor:
        return torch.stack([self.lin(fmt.format(i)) for i in range(n)])


def text_tree(ld: HFLoader, num_layers: int, tied: bool, prefix: str = "") -> dict:
    """The Qwen2 decoder's leaves (embed_tokens, layers, final_ln and the
    untied lm_head) under HF names ``{prefix}layers.{i}...``."""
    l_ = num_layers
    attn, mlp = prefix + "layers.{}.self_attn.", prefix + "layers.{}.mlp."
    layers = {
        "input_ln": ld.stack(prefix + "layers.{}.input_layernorm.weight", l_),
        **{k: {"w": ld.stack_lin(attn + f"{k}_proj.weight", l_),
               "b": ld.stack(attn + f"{k}_proj.bias", l_)} for k in ("q", "k", "v")},
        "o": {"w": ld.stack_lin(attn + "o_proj.weight", l_)},
        "post_ln": ld.stack(prefix + "layers.{}.post_attention_layernorm.weight", l_),
        **{k: {"w": ld.stack_lin(mlp + f"{k}_proj.weight", l_)} for k in ("gate", "up", "down")},
    }
    tree = {"embed_tokens": ld.t(prefix + "embed_tokens.weight"), "layers": layers,
            "final_ln": ld.t(prefix + "norm.weight")}
    if not tied:
        tree["lm_head"] = ld.lin("lm_head.weight")
    return tree


def _tree_from(cfg: Qwen2VLConfig, ld: HFLoader) -> dict:
    vl = cfg.vision.depth
    blk = "visual.blocks.{}."
    patch_w = ld.t("visual.patch_embed.proj.weight")  # [D, C, tps, ps, ps]
    visual = {
        "patch_embed": {"w": patch_w.reshape(patch_w.shape[0], -1).T.contiguous()},
        "blocks": {
            "ln1": {"scale": ld.stack(blk + "norm1.weight", vl),
                    "bias": ld.stack(blk + "norm1.bias", vl)},
            **{k: {"w": ld.stack_lin(blk + f"{name}.weight", vl),
                   "b": ld.stack(blk + f"{name}.bias", vl)}
               for k, name in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                               ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))},
            "ln2": {"scale": ld.stack(blk + "norm2.weight", vl),
                    "bias": ld.stack(blk + "norm2.bias", vl)},
        },
        "merger": {
            "ln_q": {"scale": ld.t("visual.merger.ln_q.weight"),
                     "bias": ld.t("visual.merger.ln_q.bias")},
            "fc1": {"w": ld.lin("visual.merger.mlp.0.weight"), "b": ld.t("visual.merger.mlp.0.bias")},
            "fc2": {"w": ld.lin("visual.merger.mlp.2.weight"), "b": ld.t("visual.merger.mlp.2.bias")},
        },
    }
    tree = text_tree(ld, cfg.num_hidden_layers, cfg.tie_word_embeddings)
    tree["visual"] = visual
    return tree


def from_hf_tensors(cfg: Qwen2VLConfig, tensors: Dict[str, torch.Tensor],
                    dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict:
    """The parameter tree from a ``{hf_name: tensor or ndarray}`` mapping."""
    t = {_canonical(k): v for k, v in tensors.items()}
    return _tree_from(cfg, HFLoader(t.__getitem__, dtype, device))


def checkpoint_reader(path: str, canonical: Callable[[str], str]) -> Callable[[str], torch.Tensor]:
    """``get(canonical name) -> host tensor`` over a checkpoint directory's
    safetensors shards (``model.safetensors.index.json`` when present);
    each call reads one tensor from its shard."""
    from retake_tpu_torch.utils.safetensors_io import SafeFile

    index_file = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index_file):
        with open(index_file) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
    else:
        shards = [f for f in sorted(os.listdir(path)) if f.endswith(".safetensors")]
    where = {}
    for shard in shards:
        sf = SafeFile(os.path.join(path, shard))
        for key in sf.keys():
            where[canonical(key)] = (sf, key)

    def get(name: str) -> torch.Tensor:
        sf, key = where[name]
        return sf.tensor(key)

    return get


def load_safetensors(path: str, cfg: Qwen2VLConfig, dtype: torch.dtype = torch.bfloat16,
                     device="cuda") -> dict:
    """An HF checkpoint directory (one file or index-sharded) -> the
    parameter tree on ``device``, read one tensor at a time."""
    return _tree_from(cfg, HFLoader(checkpoint_reader(path, _canonical), dtype, device))


def from_torch_model(cfg: Qwen2VLConfig, torch_model, dtype: torch.dtype = torch.bfloat16,
                     device="cuda") -> dict:
    """A live HF ``Qwen2VLForConditionalGeneration`` -> the parameter tree."""
    sd = {k: v.detach() for k, v in torch_model.state_dict().items()}
    return from_hf_tensors(cfg, sd, dtype, device)


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
