"""K3: ViT attention with fused 2-D rotary (CUDA kernel ``csrc/vit_attention.cu``).

Replaces ``retake_tpu/ops/pallas/vit_attention.py:vit_attention_qkv``. Input
is the qkv projection output with HEAD-MAJOR columns, [T, S, N, 3, D]
(``[q_h | k_h | v_h]`` per head); cos/sin [S, D] fp32. Per temporal slice
and head: rotary on q and k in fp32, cast to the activation dtype, full
bidirectional softmax over the S patches in fp32. Output [T, S, N*D].

The plain twin normalizes p and then casts it (the TPU kernel's order); the
kernel runs one pass with an online softmax, so it casts p before
normalizing and divides the accumulated P.V by the row sum at the end (the
TPU's K1 order).

The kernel's launch plan is fixed by its constants (``BQ``, ``BK``,
``RAW_STAGES``, ``OP_STAGES``): ``launch_plan`` states it as a plain
function, which the wrapper uses to refuse shapes the kernel does not take
and the CPU tests check.
"""

from __future__ import annotations

import math

import torch

from retake_tpu_torch.ops.cuda import _build, _checks
from retake_tpu_torch.utils.profiling import span

BK = 64  # keys per tile
BQ = 192  # query rows per CTA: 64 per consumer warpgroup; 576 = 3 x 192
RAW_STAGES = 2  # raw K | cos | sin tiles in flight (TMA)
OP_STAGES = 3  # rotated K | V operand tiles in flight
MAX_GRID_YZ = 65535  # heads and slices are grid dimensions y and z


def launch_plan(t: int, s: int, n: int, d: int) -> dict:
    """Grid, block and dynamic shared memory of one K3 launch, as the
    kernel's launcher sets them: one CTA per (block of BQ query rows, head,
    slice), the query block fastest; three consumer warpgroups and one
    producer warpgroup. Shared memory (the kernel's ``layout``): 1024 bytes
    of alignment slack, RAW_STAGES raw tiles (BK rows of bf16 k and f32 cos
    and sin), OP_STAGES operand tiles (rotated K as ceil(D / 64) boxes of BK
    x 128 bytes, V as D / 16 boxes of BK x 32 bytes) and their mbarriers
    (one per raw tile, full / empty per operand tile)."""
    if d not in (64, 80) or s < 1 or not 1 <= n <= MAX_GRID_YZ or not 1 <= t <= MAX_GRID_YZ:
        raise ValueError(f"K3: unsupported shape t={t} s={s} n={n} head_dim={d}")
    raw = BK * d * 2 + 2 * BK * d * 4
    operand = -(-d // 64) * BK * 128 + d // 16 * BK * 32
    smem = 1024 + RAW_STAGES * raw + OP_STAGES * operand + 8 * (RAW_STAGES + 2 * OP_STAGES)
    return dict(grid=(-(-s // BQ), n, t), block=128 * (BQ // 64 + 1), bq=BQ, bk=BK,
                stages=OP_STAGES, smem_bytes=smem)


def _rope_fp32(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [T, S, N, D]; cos/sin [S, D]; fp32 rotation, cast back to x.dtype."""
    x32 = x.to(torch.float32)
    half = x.shape[-1] // 2
    rot = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return (x32 * c + rot * s).to(x.dtype)


def vit_attention_qkv_plain(
    qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Plain version of K3."""
    t, s, n, _, d = qkv.shape
    q, k, v = qkv.unbind(dim=3)  # [T, S, N, D]
    cos, sin = cos.to(torch.float32), sin.to(torch.float32)
    qr = _rope_fp32(q, cos, sin).to(torch.float32).transpose(1, 2)  # [T, N, S, D]
    kr = _rope_fp32(k, cos, sin).to(torch.float32).transpose(1, 2)
    logits = torch.matmul(qr, kr.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = (p / p.sum(dim=-1, keepdim=True)).to(qkv.dtype)
    out = torch.matmul(p.to(torch.float32), v.to(torch.float32).transpose(1, 2))
    return out.transpose(1, 2).reshape(t, s, n * d).to(qkv.dtype)


def vit_attention_qkv(
    qkv: torch.Tensor,  # [T, S, N, 3, D] PRE-rotary, HEAD-MAJOR qkv
    cos: torch.Tensor,  # [S, D] fp32 2-D rotary tables
    sin: torch.Tensor,
) -> torch.Tensor:
    """Attention output [T, S, N*D]; rotary applied in-kernel."""
    if qkv.device.type == "cpu":
        return vit_attention_qkv_plain(qkv, cos, sin)
    name = "vit_attention_qkv"
    _checks.on_cuda(name, qkv, cos, sin)
    _checks.dtype(name, torch.bfloat16, qkv)
    _checks.dtype(name, torch.float32, cos, sin)
    t, s, n, three, d = qkv.shape
    if three != 3:
        raise ValueError(f"{name}: unsupported qkv shape {tuple(qkv.shape)}")
    launch_plan(t, s, n, d)  # refuses what the kernel does not take
    if any(x.data_ptr() % 16 for x in (qkv, cos, sin)):
        raise ValueError(f"{name}: tensors must start on a 16-byte boundary (TMA)")
    _checks.shape(name, cos, (s, d))
    _checks.shape(name, sin, (s, d))
    out = torch.empty((t, s, n * d), dtype=qkv.dtype, device=qkv.device)
    with span("k3"):
        rc = _build.library().retake_vit_attention_bf16(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
            t, s, n, d, _build.stream_of(qkv),
        )
    _build.check(rc, name)
    vit_attention_qkv.launches += 1
    return out


vit_attention_qkv.launches = 0
