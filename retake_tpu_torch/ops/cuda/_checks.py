"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def on_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def dtype(name: str, want: torch.dtype, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != want:
            raise TypeError(f"{name}: expected {want}, got {t.dtype}")


def shape(name: str, t: torch.Tensor, want) -> None:
    if tuple(t.shape) != tuple(want):
        raise ValueError(f"{name}: expected shape {tuple(want)}, got {tuple(t.shape)}")


def device_scalar(name: str, t, like: torch.Tensor) -> torch.Tensor:
    """A one-element int32 tensor on ``like``'s device (the kernels read
    lengths from device memory)."""
    if not isinstance(t, torch.Tensor) or t.numel() != 1:
        raise TypeError(f"{name}: lengths must be one-element int32 tensors")
    if t.dtype != torch.int32 or t.device != like.device:
        raise TypeError(f"{name}: lengths must be int32 on {like.device}")
    return t
