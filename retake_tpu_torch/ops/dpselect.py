"""DPSelect keyframe selection (port of ``retake_tpu/ops/dpselect.py``).

1 - cosine similarity between adjacent frames -> dissimilarity curve ->
local peaks (window 3) -> peaks boosted by +2 -> top-k frames. Returns the
kept frame indices (ascending) and which kept frames are true peaks
("keypatches", force-retained later by PivotKV).

Tie-breaking: frame i is a peak iff dis[i-1] < dis[i] and dis[i] >= dis[i+1]
(first-index argmax in the window); top-k breaks ties toward lower frame
indices (stable sort). MA-LLM compression is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-8  # torch F.cosine_similarity default eps


def _adjacent_dissimilarity(memory_bank: torch.Tensor) -> torch.Tensor:
    """dis[t, n] = 1 - cos(bank[t-1, n], bank[t, n]); dis[0, :] = 1.
    memory_bank [T, N, C] -> float32 [T, N]."""
    x = memory_bank[:-1].to(torch.float32)
    y = memory_bank[1:].to(torch.float32)
    dot = torch.sum(x * y, dim=-1)
    nx = torch.clamp(torch.sqrt(torch.sum(x * x, dim=-1)), min=_EPS)
    ny = torch.clamp(torch.sqrt(torch.sum(y * y, dim=-1)), min=_EPS)
    dis = 1.0 - dot / (nx * ny)
    return torch.cat([torch.ones_like(dis[:1]), dis], dim=0)


def _local_peaks(dis: torch.Tensor, window_size: int = 3) -> torch.Tensor:
    """Boolean peak mask along axis 0: left neighbours strictly smaller,
    right neighbours at most equal (earlier positions win ties)."""
    half = window_size // 2
    t = dis.shape[0]
    idx = torch.arange(t, device=dis.device).reshape((-1,) + (1,) * (dis.dim() - 1))
    peak = torch.ones(dis.shape, dtype=torch.bool, device=dis.device)
    for off in range(1, half + 1):
        left = torch.roll(dis, off, dims=0)
        peak &= torch.where(idx >= off, left < dis, True)
        right = torch.roll(dis, -off, dims=0)
        peak &= torch.where(idx < t - off, right <= dis, True)
    return peak


def dpselect(
    memory_bank: torch.Tensor,
    tgt_mem_len: int,
    window_size: int = 3,
    sync: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DPSelect over a [T, N, C] bank of per-frame patch embeddings.

    sync=True: pool dissimilarity over patches, select whole frames ->
      (keep [k] int64 ascending, keypatch [k] bool).
    sync=False: select independently per spatial patch ->
      (keep [k, N], keypatch [k, N]).
    """
    dis = _adjacent_dissimilarity(memory_bank)  # [T, N]
    if sync:
        dis = dis.mean(dim=1)  # [T]
    peaks = _local_peaks(dis, window_size)
    boosted = dis + torch.where(peaks, 2.0, 0.0)
    # top-k over frames, ties -> lower index, then ascending
    order = torch.sort(-torch.movedim(boosted, 0, -1), dim=-1, stable=True).indices
    keep = torch.sort(order[..., :tgt_mem_len], dim=-1).values
    if sync:
        return keep, peaks[keep]
    keep = keep.T  # [k, N]
    return keep, torch.gather(peaks, 0, keep)


def gather_keyframes(
    memory_bank: torch.Tensor, keep_indices: torch.Tensor
) -> torch.Tensor:
    """[T, N, C] x [k] -> [k, N, C], or per patch [T, N, C] x [k, N] ->
    [k, N, C]."""
    if keep_indices.dim() == 1:
        return memory_bank[keep_indices]
    idx = keep_indices[..., None].expand(-1, -1, memory_bank.shape[-1])
    return torch.gather(memory_bank, 0, idx)
