"""Plain float32 references of the two vision paths, from the published
descriptions (Qwen2-VL's ViT with 2-D rotary and the 2x2 patch merger;
SigLIP so400m, the LLaVA projector and LLaVA-Video's 2x2 bilinear pooling
and newline). Plain ``torch``; nothing of the program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SLICES = 32  # ViT slices (frame pairs) at a time
FRAMES = 16  # SigLIP frames at a time


def _f32(x, device):
    return x.to(device, torch.float32)


def _ln(x, scale, bias, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _attend(q, k, v):
    """Bidirectional attention over the last two axes: [.., N, D]."""
    w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
    return w @ v


def qwen_rotary(gh: int, gw: int, head_dim: int, merge: int, device):
    """cos / sin [gh * gw, head_dim] of one slice, patches in the
    processor's order (2x2 merge blocks row-major, row-major inside each):
    a quarter of the channels from the row, a quarter from the column,
    repeated."""
    rot = head_dim // 2
    inv = 1.0 / 10000.0 ** (np.arange(0, rot, 2, dtype=np.float64) / rot)
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")

    def blocks(p):
        return p.reshape(gh // merge, merge, gw // merge, merge).transpose(0, 2, 1, 3).ravel()

    ang = np.concatenate([blocks(hh)[:, None] * inv, blocks(ww)[:, None] * inv], axis=1)
    emb = np.concatenate([ang, ang], axis=1)
    return (torch.from_numpy(np.cos(emb)).to(device, torch.float32),
            torch.from_numpy(np.sin(emb)).to(device, torch.float32))


def _rotate(x, cos, sin):
    h = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], dim=-1) * sin


def qwen_vit(visual: dict, v: dict, patches: torch.Tensor, grid, device) -> torch.Tensor:
    """Qwen2-VL ViT: patches [t * h * w, C * tps * ps²] -> merged embeddings
    [t * h * w / 4, out] f32. Each temporal slice attends within itself."""
    t, h, w = (int(x) for x in grid)
    e, heads, depth = v["embed_dim"], v["num_heads"], v["depth"]
    hd, m = e // heads, v["spatial_merge_size"]
    s = h * w
    cos, sin = qwen_rotary(h, w, hd, m, device)
    blk = visual["blocks"]
    layers = [{k: {kk: _f32(vv[i], device) for kk, vv in blk[k].items()} for k in blk}
              for i in range(depth)]
    pe = _f32(visual["patch_embed"]["w"], device)
    mg = {k: {kk: _f32(vv, device) for kk, vv in visual["merger"][k].items()}
          for k in visual["merger"]}
    out = []
    for t0 in range(0, t, SLICES):
        tc = min(SLICES, t - t0)
        x = (_f32(patches[t0 * s : (t0 + tc) * s], device) @ pe).reshape(tc, s, e)
        for lp in layers:
            y = _ln(x, lp["ln1"]["scale"], lp["ln1"]["bias"])
            qkv = (y @ lp["qkv"]["w"] + lp["qkv"]["b"]).reshape(tc, s, 3, heads, hd)
            q, k, vv = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [tc, H, s, hd]
            a = _attend(_rotate(q, cos, sin), _rotate(k, cos, sin), vv)
            x = x + a.transpose(1, 2).reshape(tc, s, e) @ lp["proj"]["w"] + lp["proj"]["b"]
            y = _ln(x, lp["ln2"]["scale"], lp["ln2"]["bias"])
            y = y @ lp["fc1"]["w"] + lp["fc1"]["b"]
            y = y * torch.sigmoid(1.702 * y)  # quick GELU
            x = x + y @ lp["fc2"]["w"] + lp["fc2"]["b"]
        x = _ln(x, mg["ln_q"]["scale"], mg["ln_q"]["bias"]).reshape(tc * s // m**2, m * m * e)
        x = F.gelu(x @ mg["fc1"]["w"] + mg["fc1"]["b"])
        out.append(x @ mg["fc2"]["w"] + mg["fc2"]["b"])
    return torch.cat(out)


def siglip_patches(frames: torch.Tensor, image: int, ps: int, device) -> torch.Tensor:
    """uint8 frames [T, image, image, 3] -> [T, g², 3 * ps²] f32: scaled to
    [-1, 1], the valid-padding conv's grid g = image // ps (trailing pixels
    dropped), each patch in (channel, row, column) order."""
    g = image // ps
    x = (frames.to(device, torch.float32) / 255.0 - 0.5) / 0.5
    x = x[:, : g * ps, : g * ps]
    t = x.shape[0]
    return x.reshape(t, g, ps, g, ps, 3).permute(0, 1, 3, 5, 2, 4).reshape(t, g * g, 3 * ps * ps)


def siglip(tower: dict, v: dict, frames: torch.Tensor, device) -> torch.Tensor:
    """SigLIP encoder (pre-LN blocks, tanh GELU, no post-LN): frames ->
    features [T, g², D] f32."""
    d, heads, eps = v["hidden_size"], v["num_attention_heads"], v.get("layer_norm_eps", 1e-6)
    hd = d // heads
    blk = tower["blocks"]
    layers = [{k: {kk: _f32(vv[i], device) for kk, vv in blk[k].items()} for k in blk}
              for i in range(v["num_hidden_layers"])]
    pw, pb = _f32(tower["patch_embed"]["w"], device), _f32(tower["patch_embed"]["b"], device)
    pos = _f32(tower["pos_embed"], device)
    out = []
    for f0 in range(0, frames.shape[0], FRAMES):
        x = siglip_patches(frames[f0 : f0 + FRAMES], v["image_size"], v["patch_size"], device)
        x = x @ pw + pb + pos
        t, n, _ = x.shape
        for lp in layers:
            y = _ln(x, lp["ln1"]["scale"], lp["ln1"]["bias"], eps)

            def heads_of(key):
                z = y @ lp[key]["w"] + lp[key]["b"]
                return z.reshape(t, n, heads, hd).transpose(1, 2)

            a = _attend(heads_of("q"), heads_of("k"), heads_of("v"))
            x = x + a.transpose(1, 2).reshape(t, n, d) @ lp["out"]["w"] + lp["out"]["b"]
            y = _ln(x, lp["ln2"]["scale"], lp["ln2"]["bias"], eps)
            y = F.gelu(y @ lp["fc1"]["w"] + lp["fc1"]["b"], approximate="tanh")
            x = x + y @ lp["fc2"]["w"] + lp["fc2"]["b"]
        out.append(x)
    return torch.cat(out)


def llava_video_embeds(params: dict, features: torch.Tensor, grid: int, pool_stride: int,
                       device) -> torch.Tensor:
    """Projector (linear, exact GELU, linear) on every patch, then the
    per-frame grid bilinearly downsampled by the pool stride (rounded up,
    half-pixel centres), frames concatenated, ``image_newline`` last:
    [T * pooled², d] + 1 rows, f32."""
    pr = {k: {kk: _f32(vv, device) for kk, vv in params["projector"][k].items()}
          for k in params["projector"]}
    pooled = math.ceil(grid / pool_stride)
    out = []
    for f0 in range(0, features.shape[0], FRAMES):
        x = features[f0 : f0 + FRAMES]
        x = F.gelu(x @ pr["linear_1"]["w"] + pr["linear_1"]["b"])
        x = x @ pr["linear_2"]["w"] + pr["linear_2"]["b"]
        t, _, dd = x.shape
        x = x.reshape(t, grid, grid, dd).permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(pooled, pooled), mode="bilinear", align_corners=False)
        out.append(x.permute(0, 2, 3, 1).reshape(t * pooled * pooled, dd))
    out.append(_f32(params["image_newline"], device)[None])
    return torch.cat(out)
