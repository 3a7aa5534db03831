"""SigLIP vision tower (so400m geometry), frame-batched (port of
``retake_tpu/models/llava_onevision/siglip.py``).

The HF SiglipVisionModel's last encoder layer output without the
post-layernorm (``vision_feature_layer=-1``, strategy "full"). Frames are
patchified on the device ([T, 384, 384, 3] uint8 -> [T, 729, 588], the
normalization fused, the 378-px crop of the valid-padding conv), the patch
embed is one [588, 1152] product, and the 26 pre-LN blocks attend within
each frame's 729 patches.

Attention is plain torch, as in the JAX package, which has no kernel for
it: q·kᵀ in the activation dtype with fp32 logits (``torch.bmm(...,
out_dtype=torch.float32)`` on CUDA, fp32 operands on the CPU), an fp32
softmax, probabilities cast back for the product with v. The caller keeps
the frames in chunks (``frame_chunk_size``): the logits are T x 16 x 729²
fp32, 1.09 GB at 32 frames.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from retake_tpu_torch.models.llava_onevision.config import SiglipVisionConfig
from retake_tpu_torch.ops.attention import _bmm_f32
from retake_tpu_torch.ops.quantization import qlinear


def patchify_frames(frames_u8: torch.Tensor, vcfg: SiglipVisionConfig,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[T, H, W, 3] uint8 -> [T, grid*grid, 3*ps*ps] patches normalized to
    (x/255 - 0.5) / 0.5, in (channel, ph, pw) order. The grid covers
    grid*ps pixels (378 of 384 at so400m): HF's valid-padding conv drops the
    trailing rows and columns, and so does the crop here."""
    t = frames_u8.shape[0]
    g, ps = vcfg.grid, vcfg.patch_size
    x = frames_u8.to(torch.float32) / 255.0
    x = (x - 0.5) / 0.5
    x = x[:, : g * ps, : g * ps, :]
    x = x.reshape(t, g, ps, g, ps, 3).permute(0, 1, 3, 5, 2, 4)  # [T, gh, gw, C, ph, pw]
    return x.reshape(t, g * g, 3 * ps * ps).to(dtype)


def _layer_norm(x, scale, bias, eps):
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def _block(vcfg: SiglipVisionConfig, hidden: torch.Tensor, bp: dict, act_quant: bool = False):
    """One SigLIP encoder layer over [T, N, D] (pre-LN)."""
    t, n, d = hidden.shape
    nh, hd = vcfg.num_attention_heads, vcfg.head_dim
    eps = vcfg.layer_norm_eps
    x = _layer_norm(hidden, bp["ln1"]["scale"], bp["ln1"]["bias"], eps)

    def heads(y):  # [T, N, D] -> [T*nh, N, hd]
        return y.reshape(t, n, nh, hd).transpose(1, 2).reshape(t * nh, n, hd)

    q, k, v = (heads(qlinear(x, bp[key], act_quant)) for key in ("q", "k", "v"))
    logits = _bmm_f32(q, k.transpose(1, 2)) / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    del logits
    attn = torch.bmm(probs, v).reshape(t, nh, n, hd).transpose(1, 2).reshape(t, n, d)
    hidden = hidden + qlinear(attn, bp["out"], act_quant)
    x2 = _layer_norm(hidden, bp["ln2"]["scale"], bp["ln2"]["bias"], eps)
    mlp = F.gelu(qlinear(x2, bp["fc1"], act_quant), approximate="tanh")
    return hidden + qlinear(mlp, bp["fc2"], act_quant)


def siglip_tower(tower, vcfg: SiglipVisionConfig, patches: torch.Tensor,
                 act_quant: bool = False) -> torch.Tensor:
    """[T, N, patch_dim] -> the last encoder layer's output [T, N, D] (no
    post-LN). ``tower``: the ``vision_tower`` ParamTree (stacked blocks)."""
    x = patches @ tower.patch_embed.w + tower.patch_embed.b
    x = x + tower.pos_embed  # [N, D] learned
    for i in range(vcfg.num_hidden_layers):
        x = _block(vcfg, x, tower.blocks.layer(i), act_quant)
    return x


def multi_modal_projector(projector: dict, features: torch.Tensor,
                          act_quant: bool = False) -> torch.Tensor:
    """SigLIP features -> LLM space: linear, exact gelu, linear."""
    x = qlinear(features, projector["linear_1"], act_quant)
    return qlinear(F.gelu(x), projector["linear_2"], act_quant)


def apply_pooling(features: torch.Tensor, grid: int, pooled: int) -> torch.Tensor:
    """Bilinear downsample of per-frame token grids [T, grid², D] ->
    [T, pooled², D] (``F.interpolate``, bilinear, ``align_corners=False``,
    no antialias), in fp32."""
    t, _, d = features.shape
    x = features.reshape(t, grid, grid, d).permute(0, 3, 1, 2).to(torch.float32)
    x = F.interpolate(x, size=(pooled, pooled), mode="bilinear", align_corners=False)
    return x.permute(0, 2, 3, 1).reshape(t, pooled * pooled, d).to(features.dtype)
