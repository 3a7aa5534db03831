"""Qwen2-VL vision transformer (port of ``retake_tpu/models/qwen2_vl/vision.py``).

Every temporal slice of a video has the same h*w patches, so attention runs
batched over [t, hw, D] (full bidirectional within a slice). Patches arrive
in the 2x2 spatial-merge block order, so the merger is a plain reshape to
[t*hw/4, 4*D]. Attention is K3 (``ops/cuda/vit_attention.py``) with the
2-D rotary fused in; it reads the qkv projection output in head-major
column order, so ``VisionTower`` reorders the qkv weight columns once, when
it is built (the parameter ``blocks.qkv.w`` is stored head-major).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from retake_tpu_torch.models.qwen2_vl.config import Qwen2VisionConfig
from retake_tpu_torch.models.qwen2_vl.params import ParamTree
from retake_tpu_torch.ops.cuda import vit_attention


def vision_rotary_tables(
    grid_h: int, grid_w: int, head_dim: int, merge_size: int, theta: float = 10000.0
):
    """cos/sin [hw, head_dim] numpy fp32 for one temporal slice.

    Patch order follows the spatial-merge block permutation (block_row,
    block_col, intra_row, intra_col). Angle channels: first head_dim/4 from
    the h coordinate, next head_dim/4 from w, then the same repeated.
    """
    half = head_dim // 2  # rotary dim
    inv_freq = 1.0 / (theta ** (np.arange(0, half, 2, dtype=np.float32) / half))
    m = merge_size
    hpos = np.broadcast_to(np.arange(grid_h)[:, None], (grid_h, grid_w))
    wpos = np.broadcast_to(np.arange(grid_w)[None, :], (grid_h, grid_w))

    def blockify(p):
        return p.reshape(grid_h // m, m, grid_w // m, m).transpose(0, 2, 1, 3).reshape(-1)

    hpos, wpos = blockify(hpos), blockify(wpos)
    hfreq = hpos[:, None].astype(np.float32) * inv_freq  # [hw, hd/4]
    wfreq = wpos[:, None].astype(np.float32) * inv_freq
    freqs = np.concatenate([hfreq, wfreq], axis=-1)  # [hw, hd/2]
    emb = np.concatenate([freqs, freqs], axis=-1)  # [hw, hd]
    return np.cos(emb), np.sin(emb)


def _layer_norm(x, scale, bias, eps=1e-6):
    x32 = x.to(torch.float32)
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _linear(x, p):
    return x @ p["w"] + p["b"]


def _block(vcfg: Qwen2VisionConfig, cos, sin, hidden, bp, attn_impl: str):
    """One ViT block over [t, hw, D]; ``bp['qkv']`` is head-major."""
    t, hw, _ = hidden.shape
    nh, hd = vcfg.num_heads, vcfg.head_dim
    x = _layer_norm(hidden, bp["ln1"]["scale"], bp["ln1"]["bias"])
    qkv = _linear(x, bp["qkv"]).reshape(t, hw, nh, 3, hd)
    if attn_impl == "pallas":
        attn = vit_attention.vit_attention_qkv(qkv, cos, sin)
    else:
        attn = vit_attention.vit_attention_qkv_plain(qkv, cos, sin)
    hidden = hidden + _linear(attn, bp["proj"])
    x2 = _layer_norm(hidden, bp["ln2"]["scale"], bp["ln2"]["bias"])
    return hidden + _linear(_quick_gelu(_linear(x2, bp["fc1"])), bp["fc2"])


def head_major_qkv(qkv: dict, num_heads: int) -> dict:
    """Reorder stacked qkv columns [q | k | v] (each N*D) to head-major
    [q_h | k_h | v_h] per head: w [L, d, 3*d], b [L, 3*d]."""
    w, b = qkv["w"], qkv["b"]
    lyr, d, _ = w.shape
    hd = d // num_heads
    w = w.reshape(lyr, d, 3, num_heads, hd).transpose(2, 3).reshape(lyr, d, 3 * d)
    b = b.reshape(lyr, 3, num_heads, hd).transpose(1, 2).reshape(lyr, 3 * d)
    return {"w": w.contiguous(), "b": b.contiguous()}


class VisionTower(nn.Module):
    """Patch embed -> blocks -> 2x2 merger; parameters under the JAX keys
    ``patch_embed``, ``blocks``, ``merger``."""

    def __init__(self, vcfg: Qwen2VisionConfig, params: dict):
        super().__init__()
        self.vcfg = vcfg
        blocks = dict(params["blocks"])
        blocks["qkv"] = head_major_qkv(blocks["qkv"], vcfg.num_heads)
        self.patch_embed = ParamTree(params["patch_embed"])
        self.blocks = ParamTree(blocks)
        self.merger = ParamTree(params["merger"])
        self._rotary = {}

    def rotary(self, grid_h: int, grid_w: int, device) -> tuple:
        key = (grid_h, grid_w, str(device))
        if key not in self._rotary:
            v = self.vcfg
            cos, sin = vision_rotary_tables(grid_h, grid_w, v.head_dim, v.spatial_merge_size)
            self._rotary[key] = (
                torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)
            )
        return self._rotary[key]

    def forward(
        self,
        pixel_patches: torch.Tensor,  # [t*hw, in_channels*tps*ps*ps]
        grid_t: int,
        grid_h: int,
        grid_w: int,
        attn_impl: str = "pallas",
    ) -> torch.Tensor:
        """LLM-space video embeddings [t * hw / merge^2, out_hidden]."""
        v = self.vcfg
        hw = grid_h * grid_w
        x = (pixel_patches @ self.patch_embed.w).reshape(grid_t, hw, v.embed_dim)
        cos, sin = self.rotary(grid_h, grid_w, x.device)
        for i in range(v.depth):
            x = _block(v, cos, sin, x, self.blocks.layer(i), attn_impl)
        m2 = v.spatial_merge_size**2
        mp = self.merger
        x = _layer_norm(x, mp.ln_q.scale, mp.ln_q.bias)
        x = x.reshape(grid_t * hw // m2, m2 * v.embed_dim)
        x = F.gelu(x @ mp.fc1.w + mp.fc1.b)
        return x @ mp.fc2.w + mp.fc2.b
