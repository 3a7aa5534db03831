"""DPSelect keyframe selection (port of ``retake_tpu/ops/dpselect.py``).

1 - cosine similarity between adjacent frames -> dissimilarity curve ->
local peaks (window 3) -> peaks boosted by +2 -> top-k frames. Returns the
kept frame indices (ascending) and which kept frames are true peaks
("keypatches", force-retained later by PivotKV).

Tie-breaking: frame i is a peak iff dis[i-1] < dis[i] and dis[i] >= dis[i+1]
(first-index argmax in the window); top-k breaks ties toward lower frame
indices (stable sort).

MA-LLM / MA-LLM-hard (``malm_compress``): merge the most similar adjacent
pair of frames until ``tgt_mem_len`` are left, by size-weighted average or
(hard) by overwriting, over a fixed-size buffer with an alive mask, then
compact the survivors in temporal order.
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


def _merge_once(bank: torch.Tensor, sizes: torch.Tensor, sync: bool, hard: bool):
    """One MA-LLM merge over a fixed buffer: ``bank`` [T, N, C] running frame
    features, ``sizes`` [T, N] f32 with 0 marking a frame merged away. The
    most similar pair (i, next alive after i) merges the later frame into the
    earlier one, for all patches at once (``sync``) or per patch column;
    the later frame dies. Returns new (bank, sizes)."""
    t = bank.shape[0]
    dev = bank.device
    alive = sizes[:, 0] > 0
    idx = torch.arange(t, device=dev)
    pos = torch.where(alive, idx, t)
    first_alive_from = torch.flip(torch.cummin(torch.flip(pos, [0]), 0).values, [0])
    nxt = torch.cat([first_alive_from[1:], torch.full((1,), t, device=dev)])  # strict successor
    has_next = (nxt < t) & alive
    nxt_safe = torch.clamp(nxt, max=t - 1)
    x = bank.to(torch.float32)
    y = bank[nxt_safe].to(torch.float32)
    dot = torch.sum(x * y, dim=-1)
    nx = torch.clamp(torch.sqrt(torch.sum(x * x, dim=-1)), min=_EPS)
    ny = torch.clamp(torch.sqrt(torch.sum(y * y, dim=-1)), min=_EPS)
    sim = dot / (nx * ny)  # [T, N]
    if sync:
        sim = sim.mean(dim=1, keepdim=True) * torch.ones_like(sim)
    sim = torch.where(has_next[:, None], sim, -torch.inf)
    bank, sizes = bank.clone(), sizes.clone()
    if sync:
        i = torch.argmax(sim[:, 0])  # first index of the largest
        j = nxt_safe[i]
        if hard:
            new_row, new_size = bank[j], sizes[i]
        else:
            tot = sizes[i] + sizes[j]
            new_row = (bank[i] * sizes[i][:, None] + bank[j] * sizes[j][:, None]) / tot[:, None]
            new_size = tot
        bank[i] = new_row.to(bank.dtype)
        sizes[i] = new_size
        sizes[j] = 0.0
        return bank, sizes
    i = torch.argmax(sim, dim=0)  # [N]
    j = nxt_safe[i]
    cols = torch.arange(bank.shape[1], device=dev)
    bi, bj = bank[i, cols], bank[j, cols]  # [N, C]
    si, sj = sizes[i, cols], sizes[j, cols]  # [N]
    if hard:
        new_row, new_size = bj, si
    else:
        tot = si + sj
        new_row = (bi * si[:, None] + bj * sj[:, None]) / tot[:, None]
        new_size = tot
    bank[i, cols] = new_row.to(bank.dtype)
    sizes[i, cols] = new_size
    sizes[j, cols] = 0.0
    return bank, sizes


def malm_compress(
    memory_bank: torch.Tensor,
    tgt_mem_len: int,
    sync: bool = False,
    hard: bool = False,
) -> torch.Tensor:
    """MA-LLM (``hard``: MA-LLM-hard) merging of a [T, N, C] bank down to
    ``tgt_mem_len`` frames: T - tgt_mem_len merges, then the survivors in
    temporal order (per patch column unless ``sync``). Returns
    [tgt_mem_len, N, C]."""
    t, n, c = memory_bank.shape
    sizes = torch.ones((t, n), dtype=torch.float32, device=memory_bank.device)
    bank = memory_bank
    for _ in range(t - tgt_mem_len):
        bank, sizes = _merge_once(bank, sizes, sync, hard)
    rows = torch.arange(t, device=bank.device)[:, None]
    order = torch.argsort(torch.where(sizes > 0, rows, t + rows), dim=0, stable=True)
    keep = order[:tgt_mem_len]  # [tgt, N]
    return torch.gather(bank, 0, keep[..., None].expand(-1, -1, c))


def malm_hard_compress(memory_bank: torch.Tensor, tgt_mem_len: int,
                       sync: bool = False) -> torch.Tensor:
    """MA-LLM-hard: ``malm_compress(..., hard=True)``."""
    return malm_compress(memory_bank, tgt_mem_len, sync=sync, hard=True)
