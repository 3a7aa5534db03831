"""Anyres still-image geometry and feature packing for LLaVA-OneVision
(port of ``retake_tpu/models/llava_onevision/anyres.py``).

HF's ``image_size_to_num_patches`` / ``pack_image_features`` semantics:
grid reshape, unpad, the anyres_max_N bilinear downscale, an
``image_newline`` after every row, the base tile first. The geometry
(best resolution, grid shape, unpad bounds, token count, tiles) runs on the
host per image; only the packing touches the device.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def select_best_resolution(
    original_hw: Tuple[int, int], pinpoints: Sequence[Tuple[int, int]]
) -> Tuple[int, int]:
    """HF select_best_resolution: maximize effective resolution, then
    minimize wasted area."""
    oh, ow = original_hw
    best, max_eff, min_waste = None, 0, float("inf")
    for h, w in pinpoints:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = (w * h) - eff
        if eff > max_eff or (eff == max_eff and waste < min_waste):
            max_eff, min_waste, best = eff, waste, (h, w)
    return best


def anyres_grid_shape(
    original_hw, pinpoints, tile_size: int
) -> Tuple[int, int]:
    """(num_patch_height, num_patch_width) of the best-fit anyres grid."""
    bh, bw = select_best_resolution(original_hw, pinpoints)
    return bh // tile_size, bw // tile_size


def image_size_to_num_patches(original_hw, pinpoints, tile_size: int) -> int:
    """Grid patches + 1 base tile (HF image_size_to_num_patches)."""
    nph, npw = anyres_grid_shape(original_hw, pinpoints, tile_size)
    return nph * npw + 1


def unpad_bounds(
    original_hw, current_hw
) -> Tuple[int, int, int, int]:
    """(h0, h1, w0, w1) slice removing aspect-ratio padding (HF unpad_image)."""
    oh, ow = original_hw
    ch, cw = current_hw
    if ow / oh > cw / ch:
        new_h = int(round(oh * (cw / ow), 7))
        pad = (ch - new_h) // 2
        return pad, ch - pad, 0, cw
    new_w = int(round(ow * (ch / oh), 7))
    pad = (cw - new_w) // 2
    return 0, ch, pad, cw - pad


def packed_token_count(
    original_hw,
    *,
    grid_side: int,
    pinpoints,
    tile_size: int,
    vision_aspect_ratio: str = "anyres_max_9",
) -> int:
    """Token count pack_image_feature will produce for an (h, w) image —
    shared by the processor (placeholder expansion) and tests."""
    g = grid_side
    nph, npw = anyres_grid_shape(original_hw, pinpoints, tile_size)
    h0, h1, w0, w1 = unpad_bounds(original_hw, (nph * g, npw * g))
    ch, cw = h1 - h0, w1 - w0
    max_patches = int(vision_aspect_ratio.removeprefix("anyres_max_"))
    ratio = math.sqrt(ch * cw / (max_patches * g**2))
    if ratio > 1.1:
        ch, cw = int(ch // ratio), int(cw // ratio)
    return g * g + ch * (cw + 1)


def image_to_anyres_tiles(
    image_u8,  # [H, W, 3] uint8
    *,
    tile_size: int,
    pinpoints,
):
    """HF LlavaOnevisionImageProcessor.get_image_patches semantics:
    [base resized to (S, S)] + aspect-preserving resize to the best-fit
    resolution, centered zero padding, row-major SxS tiles.

    Returns (tiles [n_patch, S, S, 3] uint8, (h, w)).
    """
    import numpy as np
    from PIL import Image

    h, w = image_u8.shape[:2]
    bh, bw = select_best_resolution((h, w), pinpoints)
    # get_patch_output_size: fit inside (bh, bw), ceil on the minor axis
    scale_w, scale_h = bw / w, bh / h
    if scale_w < scale_h:
        nw, nh = bw, min(math.ceil(h * scale_w), bh)
    else:
        nh, nw = bh, min(math.ceil(w * scale_h), bw)
    img = Image.fromarray(image_u8)
    resized = np.asarray(img.resize((nw, nh), resample=Image.BICUBIC))
    pad_y, r_y = divmod(bh - nh, 2)
    pad_x, r_x = divmod(bw - nw, 2)
    padded = np.zeros((bh, bw, 3), np.uint8)
    padded[pad_y : pad_y + nh, pad_x : pad_x + nw] = resized
    s = tile_size
    tiles = [
        padded[i : i + s, j : j + s]
        for i in range(0, bh, s)
        for j in range(0, bw, s)
    ]
    base = np.asarray(img.resize((s, s), resample=Image.BICUBIC))
    return np.stack([base] + tiles), (h, w)


def pack_image_feature(
    feature: torch.Tensor,  # [num_patches, tokens_per_tile, d] projected
    original_hw: Tuple[int, int],
    *,
    grid_side: int,  # token grid per tile (image_size // patch_size)
    pinpoints: Sequence[Tuple[int, int]],
    tile_size: int,  # pixels per tile (vision image_size)
    image_newline: torch.Tensor,  # [d]
    vision_aspect_ratio: str = "anyres_max_9",
) -> torch.Tensor:
    """One image's anyres token stream [n_tokens, d] (HF pack_image_features)."""
    newline = image_newline.to(feature.dtype)
    if feature.shape[0] == 1:
        return torch.cat([feature[0], newline[None]], dim=0)
    base, rest = feature[0], feature[1:]
    h = w = grid_side
    d = feature.shape[-1]
    nph, npw = anyres_grid_shape(original_hw, pinpoints, tile_size)
    if rest.shape[0] != nph * npw:
        raise ValueError(f"{rest.shape[0]} grid tiles for a {nph}x{npw} anyres grid")
    f = rest.reshape(nph, npw, h, w, d).permute(4, 0, 2, 1, 3).reshape(d, nph * h, npw * w)
    h0, h1, w0, w1 = unpad_bounds(original_hw, (nph * h, npw * w))
    f = f[:, h0:h1, w0:w1]
    max_patches = int(vision_aspect_ratio.removeprefix("anyres_max_"))
    ch, cw = f.shape[1:]
    ratio = math.sqrt(ch * cw / (max_patches * h**2))
    if ratio > 1.1:  # F.interpolate bilinear, align_corners=False, no antialias
        f = F.interpolate(f[None], size=(int(ch // ratio), int(cw // ratio)), mode="bilinear",
                          align_corners=False)[0]
        ch, cw = f.shape[1:]
    col = newline[:, None, None].expand(d, ch, 1)
    f = torch.cat([f, col], dim=2).reshape(d, -1).T  # [ch*(cw+1), d], a newline per row
    return torch.cat([base, f], dim=0)
