"""LLaVA-OneVision parameters: random init, HF checkpoint conversion and the
JAX weight bridge (port of ``retake_tpu/models/llava_onevision/params.py``).

The tree keeps the JAX package's keys and layouts: the Qwen2 decoder's
(``embed_tokens``, ``layers``, ``final_ln``, ``lm_head``; see
``models/qwen2_vl/params.py``) plus

  vision_tower/{patch_embed/{w, b}, pos_embed,
                blocks/{ln1, q, k, v, out, ln2, fc1, fc2}}   (stacked [L, ...])
  projector/{linear_1, linear_2};  image_newline [d]

HF checkpoints load in both naming eras (``language_model.model.*`` /
``vision_tower.vision_model.*`` and the transformers>=4.52
``model.language_model.*`` scheme) and in the lmms-lab LLaVA-Video naming
(``convert_llava_video_weights``, the rename map of
``scripts/convert_llava_video_weights.py``).
"""

from __future__ import annotations

import math
import re
from typing import Dict

import torch

from retake_tpu_torch.models.llava_onevision.config import LlavaOnevisionConfig
from retake_tpu_torch.models.qwen2_vl import params as qwen_params
from retake_tpu_torch.ops import quantization as q8

# the JAX weight bridge is generic over parameter trees
from_jax_params = qwen_params.from_jax_params

_SIGLIP_LINEARS = ("q", "k", "v", "out", "fc1", "fc2")


def init_params(
    cfg: LlavaOnevisionConfig,
    seed: int = 0,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    quantize_int8: bool = False,
    quantize_vision_int8: bool = False,
) -> dict:
    """Random parameters at real geometry, drawn on ``device`` from seeded
    ``torch.Generator`` s (the text decoder from ``seed + 1``, as in the JAX
    init). ``quantize_int8`` quantizes the decoder linears, embedding and
    head and ``quantize_vision_int8`` the SigLIP block linears and the
    projector, each stack as it is drawn, so the whole bf16 tree never
    exists; the result equals ``quantize_llm_int8`` /
    ``quantize_siglip_int8`` of the unquantized tree of the same seed."""
    out = qwen_params.init_params(cfg.text, seed + 1, dtype, device, quantize_int8, vision=False)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def w(*shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(
            shape[-2] if len(shape) > 1 else shape[-1])
        x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return x * torch.tensor(scale, dtype=dtype)

    def qw(*shape):
        x = w(*shape)
        return q8.quantize_linear_stack(x) if quantize_vision_int8 else {"w": x}

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    v = cfg.vision
    d, m, l_ = v.hidden_size, v.intermediate_size, v.num_hidden_layers
    blocks = {"ln1": {"scale": ones(l_, d), "bias": zeros(l_, d)}}
    for key in ("q", "k", "v", "out"):
        blocks[key] = {**qw(l_, d, d), "b": zeros(l_, d)}
    blocks["ln2"] = {"scale": ones(l_, d), "bias": zeros(l_, d)}
    blocks["fc1"] = {**qw(l_, d, m), "b": zeros(l_, m)}
    blocks["fc2"] = {**qw(l_, m, d), "b": zeros(l_, d)}
    out["vision_tower"] = {
        "patch_embed": {"w": w(3 * v.patch_size**2, d), "b": zeros(d)},
        "pos_embed": w(v.num_patches, d, scale=0.02),
        "blocks": blocks,
    }
    td = cfg.text.hidden_size
    out["projector"] = {
        "linear_1": {**qw(d, td), "b": zeros(td)},
        "linear_2": {**qw(td, td), "b": zeros(td)},
    }
    out["image_newline"] = w(td, scale=0.02)
    return out


def _canonical(name: str) -> str:
    """Normalize across HF eras and lmms-lab originals."""
    n = name
    n = re.sub(r"^model\.language_model\.", "language_model.", n)
    n = re.sub(r"^model\.vision_tower\.", "vision_tower.", n)
    n = re.sub(r"^model\.multi_modal_projector\.", "multi_modal_projector.", n)
    n = re.sub(r"^model\.image_newline$", "image_newline", n)
    n = re.sub(r"^language_model\.model\.", "language_model.", n)
    n = re.sub(r"^language_model\.lm_head\.", "lm_head.", n)
    # lmms-lab original LLaVA-Video naming
    n = re.sub(r"^model\.mm_projector\.0\.", "multi_modal_projector.linear_1.", n)
    n = re.sub(r"^model\.mm_projector\.2\.", "multi_modal_projector.linear_2.", n)
    n = n.replace(".vision_resampler", "")
    n = re.sub(r"^vision_tower\.vision_tower\.", "vision_tower.", n)
    n = re.sub(r"^model\.", "language_model.", n)  # model.layers.* (lmms-lab)
    n = re.sub(r"^vision_tower\.vision_model\.", "vision_tower.", n)
    return n


def _tree_from(cfg: LlavaOnevisionConfig, ld) -> dict:
    tree = qwen_params.text_tree(ld, cfg.text.num_hidden_layers, cfg.text.tie_word_embeddings,
                                 prefix="language_model.")
    vl = cfg.vision.num_hidden_layers
    enc = "vision_tower.encoder.layers.{}."
    patch_w = ld.t("vision_tower.embeddings.patch_embedding.weight")  # [D, 3, ps, ps]
    names = dict(q="self_attn.q_proj", k="self_attn.k_proj", v="self_attn.v_proj",
                 out="self_attn.out_proj", fc1="mlp.fc1", fc2="mlp.fc2")
    blocks = {"ln1": {"scale": ld.stack(enc + "layer_norm1.weight", vl),
                      "bias": ld.stack(enc + "layer_norm1.bias", vl)}}
    for key in _SIGLIP_LINEARS:
        blocks[key] = {"w": ld.stack_lin(enc + names[key] + ".weight", vl),
                       "b": ld.stack(enc + names[key] + ".bias", vl)}
    blocks["ln2"] = {"scale": ld.stack(enc + "layer_norm2.weight", vl),
                     "bias": ld.stack(enc + "layer_norm2.bias", vl)}
    tree["vision_tower"] = {
        "patch_embed": {"w": patch_w.reshape(patch_w.shape[0], -1).T.contiguous(),
                        "b": ld.t("vision_tower.embeddings.patch_embedding.bias")},
        "pos_embed": ld.t("vision_tower.embeddings.position_embedding.weight"),
        "blocks": blocks,
    }
    tree["projector"] = {
        k: {"w": ld.lin(f"multi_modal_projector.{k}.weight"),
            "b": ld.t(f"multi_modal_projector.{k}.bias")} for k in ("linear_1", "linear_2")
    }
    tree["image_newline"] = ld.t("image_newline")
    return tree


def from_hf_tensors(cfg: LlavaOnevisionConfig, tensors: Dict[str, torch.Tensor],
                    dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict:
    """The parameter tree from a ``{hf_name: tensor or ndarray}`` mapping."""
    t = {_canonical(k): val for k, val in tensors.items()}
    return _tree_from(cfg, qwen_params.HFLoader(t.__getitem__, dtype, device))


def load_safetensors(path: str, cfg: LlavaOnevisionConfig, dtype: torch.dtype = torch.bfloat16,
                     device="cuda") -> dict:
    """An HF checkpoint directory (one file or index-sharded) -> the tree
    on ``device``, read one tensor at a time."""
    get = qwen_params.checkpoint_reader(path, _canonical)
    return _tree_from(cfg, qwen_params.HFLoader(get, dtype, device))


def from_torch_model(cfg: LlavaOnevisionConfig, torch_model, dtype: torch.dtype = torch.bfloat16,
                     device="cuda") -> dict:
    """A live HF ``LlavaOnevisionForConditionalGeneration`` -> the tree."""
    sd = {k: v.detach() for k, v in torch_model.state_dict().items()}
    return from_hf_tensors(cfg, sd, dtype, device)


# lmms-lab LLaVA-Video -> HF LlavaOnevision names, ordered prefix rewrites
# (scripts/convert_llava_video_weights.py, reference
# convert_llava_video_weights_to_hf.py:54-65)
RENAMES = [
    ("model.image_newline", "image_newline"),
    ("model.vision_tower.vision_tower.", "vision_tower."),
    ("model.mm_projector.0.", "multi_modal_projector.linear_1."),
    ("model.mm_projector.2.", "multi_modal_projector.linear_2."),
    ("model.", "language_model.model."),
    ("lm_head.", "language_model.lm_head."),
]


def _remap(name: str) -> str:
    name = name.replace(".vision_resampler", "")
    for old, new in RENAMES:
        if name.startswith(old) or name == old.rstrip("."):
            return new + name[len(old):]
    return name


def convert_llava_video_weights(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An lmms-lab LLaVA-Video state dict under HF LlavaOnevision names
    (tensors passed through)."""
    return {_remap(k): v for k, v in tensors.items()}
