"""Rotary position embeddings: M-RoPE and YaRN (port of ``retake_tpu/ops/rope.py``).

* Frequencies and angles are computed in float32; cos/sin are cast to the
  activation dtype before application.
* ``reverse=True`` rotates by the negative angle and divides by
  ``attention_scaling**2``, undoing a forward application whose cos/sin were
  premultiplied by ``attention_scaling`` (YaRN mscale).
* M-RoPE splits the head-dim channel halves into (temporal, height, width)
  sections given by ``mrope_section``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch


def default_inv_freq(head_dim: int, theta: float) -> np.ndarray:
    """Standard RoPE inverse frequencies, float32 numpy, shape [head_dim // 2]."""
    return 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)
    ).astype(np.float32)


def yarn_inv_freq(
    head_dim: int,
    theta: float,
    factor: float,
    original_max_position_embeddings: int,
    beta_fast: float = 32.0,
    beta_slow: float = 1.0,
) -> Tuple[np.ndarray, float]:
    """YaRN NTK-by-parts inverse frequencies + attention scaling factor.
    Returns (inv_freq [head_dim//2] float32, attention_scaling)."""

    def correction_dim(num_rotations: float) -> float:
        return (
            head_dim
            * math.log(original_max_position_embeddings / (num_rotations * 2 * math.pi))
        ) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001  # avoid singular ramp

    pos_freqs = theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)
    inv_extrapolation = 1.0 / pos_freqs
    inv_interpolation = 1.0 / (factor * pos_freqs)

    ramp = (np.arange(head_dim // 2, dtype=np.float32) - low) / (high - low)
    ramp = np.clip(ramp, 0.0, 1.0)
    extrapolation_factor = 1.0 - ramp

    inv_freq = (
        inv_interpolation * (1.0 - extrapolation_factor)
        + inv_extrapolation * extrapolation_factor
    ).astype(np.float32)

    attention_scaling = 1.0 if factor <= 1.0 else 0.1 * math.log(factor) + 1.0
    return inv_freq, float(attention_scaling)


def compute_cos_sin(
    inv_freq: torch.Tensor,
    position_ids: torch.Tensor,
    attention_scaling: float = 1.0,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Angle tables [..., seq, head_dim] for position ids [..., seq]
    (half-angles duplicated), premultiplied by ``attention_scaling`` and cast
    to ``dtype``."""
    freqs = position_ids[..., None].to(torch.float32) * inv_freq.to(torch.float32)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = torch.cos(emb) * attention_scaling
    sin = torch.sin(emb) * attention_scaling
    return cos.to(dtype), sin.to(dtype)


def select_mrope(table: torch.Tensor, mrope_section: Sequence[int]) -> torch.Tensor:
    """Combine a [3, ..., S, D] per-axis angle table into [..., S, D]: channel
    block i of the 2x-repeated section list comes from axis ``i % 3``."""
    sections = list(mrope_section) * 2
    pieces = []
    offset = 0
    for i, sec in enumerate(sections):
        pieces.append(table[i % 3, ..., offset : offset + sec])
        offset += sec
    return torch.cat(pieces, dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    reverse: bool = False,
    attention_scaling: float = 1.0,
) -> torch.Tensor:
    """Rotate ``x`` ([..., H, S, D]) by cos/sin ([..., S, D], broadcast over
    heads). ``reverse=True`` applies the inverse rotation and removes a
    squared attention-scaling factor (de-rotation before PivotKV scoring)."""
    if cos.dim() == x.dim() - 1:
        cos, sin = cos.unsqueeze(-3), sin.unsqueeze(-3)
    if reverse:
        return ((x * cos) - (rotate_half(x) * sin)) / (attention_scaling**2)
    return (x * cos) + (rotate_half(x) * sin)
