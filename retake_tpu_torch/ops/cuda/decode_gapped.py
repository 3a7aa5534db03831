"""K4: batched gap-layout decode attention state (CUDA kernel ``csrc/decode_gapped.cu``).

Replaces ``retake_tpu/ops/pallas/decode_gapped.py:decode_gapped_flash_state``
in both its modes. For each slot b, KV head and query row g it returns the
unnormalized flash state over the slot's live columns ``[0, final_len[b]) u
[dec_start[b], write_end)``: ``acc`` [B, KV, G, D], ``m`` and ``l`` [B, KV,
G], all fp32. A slot with no live column gives m = -1e30, l = 0, acc = 0.
``ops.attention.decode_attention_batch_gapped`` merges the current token
and normalizes.

int8-KV mode (``k_scale`` / ``v_scale`` [B, KV, S] f32 given, K/V int8):
the scales are commuted as in the TPU kernel: int8 -> bf16 without the
scale (exact), logits ``(q . k) / sqrt(d) * ks`` and only then the mask,
``l`` sums the unscaled p, and ``p * vs`` is rounded to bf16 for the
product with V. This mode launches ``decode_gapped_flash_state_int8`` and
counts there.

The TPU kernel's block rules (``_pick_block_k``, ROWS padding, the dense
grid's divisor search, the int8 scale-plane row alignment) are not carried
over: the CUDA kernel takes any S and masks its own tail tile. The serving
loop hands it the contiguous view ``k_all[layer]``, so there is no
stacked-cache mode either.

On CUDA, ``final_len`` and ``dec_start`` are int32 device tensors [B] that
the kernel reads itself, and ``write_end`` is a host int (the server's write
pointer lives on the host), so a launch needs no device read.

One call is one launch. Its splits write their partial states to a
workspace and count their arrival per group of splits; the last of a group
merges the group, and the last group merges the groups, each in a fixed
order, and sets its counter back to 0. The workspace and counters are
made once per (device, plan), the counters zeroed then, and reused by every
later call with that plan: calls on one stream run in order, so no two
launches share them at once (calls on two streams at once with one plan
would). The outputs are one ``torch.empty`` viewed as acc, m and l. Nothing
else is allocated, so a call can be captured in a CUDA graph.
"""

from __future__ import annotations

import functools
import math

import torch

from retake_tpu_torch.ops.cuda import _build, _checks

NEG_INF = -1e30
# the kernel's fixed plan (csrc/decode_gapped.cu): columns per tile and per
# CTA, ring stages, consumer warps, chosen by timing at the serving shapes
# (PERF.md); the most splits of one (slot, head) it takes, and the splits
# its merge sums as one group first
BK = 64
SPLIT = 1024
STAGES = 3
NCW = 4
MAX_SPLITS = 128
GSPLITS = 8
MAX_GROUP = 16  # query rows per KV head: one mma.sync row tile


def live_columns(s: int, final_len, dec_start, write_end, device) -> torch.Tensor:
    """[B, S] bool: column j of slot b is live."""
    idx = torch.arange(s, device=device)[None, :]
    return (idx < final_len[:, None]) | ((idx >= dec_start[:, None]) & (idx < write_end))


def decode_gapped_flash_state_plain(
    query: torch.Tensor,  # [B, KV, G, D]
    key_cache: torch.Tensor,  # [B, KV, S, D] (int8 with k_scale)
    value_cache: torch.Tensor,
    final_len: torch.Tensor,  # [B] int
    dec_start: torch.Tensor,  # [B] int
    write_end,  # int or 0-d int tensor
    k_scale=None,  # [B, KV, S] f32
    v_scale=None,
):
    """Plain version of K4: the same unnormalized state from an fp32 masked
    softmax over the whole bucket. p (times the value scale in int8 mode) is
    rounded to the query dtype before the product with V, as the TPU kernel
    and the CUDA kernel round it."""
    d = query.shape[-1]
    q = query.to(torch.float32)
    logits = torch.matmul(q, key_cache.to(torch.float32).transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :]
    valid = live_columns(key_cache.shape[2], final_len, dec_start, write_end, query.device)
    valid = valid[:, None, None, :]
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    acc = torch.matmul(p.to(query.dtype).to(torch.float32), value_cache.to(torch.float32))
    return acc, m, l


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, kv: int, g: int, s: int, d: int, int8: bool) -> dict:
    """Grid, block, dynamic shared memory, workspace and counters of one K4
    launch, as the kernel's constants fix them: one CTA per (SPLIT-column
    range, slot x KV head), split index fastest; NCW consumer warps and one
    producer warp. Shared memory (the kernel's ``Plan``): 1024 bytes of
    alignment slack, STAGES ring stages (each 1024-aligned) of [K tile | V
    tile | int8: two f32 scale rows], each tile BK cache rows, or the merge
    (its scratch, then the warps' states or two staging buffers of
    partials) where that is larger, then 2 * STAGES + 2 mbarriers. The workspace
    holds every split's partial (acc [G, D], m and l [G]) in f32 and one per
    group of GSPLITS splits, and int32 arrival counters: one per (slot, head)
    for its groups and one per group for its splits. Raises on what the
    kernel does not take."""
    if not (1 <= g <= MAX_GROUP) or d not in (64, 128) or s < 1 or b < 1 or kv < 1:
        raise ValueError(f"K4: unsupported group {g}, head_dim {d}, S {s} or batch {b} x {kv}")
    n_split = -(-s // SPLIT)
    if b * kv > 65535 or n_split > MAX_SPLITS:
        raise ValueError(f"K4: {b} x {kv} (slot, head) pairs or S {s} exceed the kernel's grid")
    stage = -(-(2 * BK * d * (1 if int8 else 2) + (2 * BK * 4 if int8 else 0)) // 1024) * 1024
    max_src = max(GSPLITS, MAX_SPLITS // GSPLITS)
    scratch = -(-(MAX_GROUP + MAX_SPLITS + 2 * (MAX_SPLITS // GSPLITS) + 1
                  + max_src * 2 * MAX_GROUP) * 4 // 16) * 16
    merge = scratch + max((NCW * 16 * d + 2 * NCW * 16) * 4, 2 * MAX_GROUP * d * 4)
    n_groups = -(-n_split // GSPLITS)
    return dict(grid=(n_split, b * kv), block=32 * (NCW + 1), bk=BK, split=SPLIT,
                stages=STAGES, consumer_warps=NCW,
                smem_bytes=1024 + max(STAGES * stage, merge) + (2 * STAGES + 2) * 8,
                workspace_floats=b * kv * (n_split + n_groups) * g * (d + 2),
                counters=b * kv * (1 + n_groups))


# (device, plan) -> (workspace f32, counters int32), made once and reused
_workspaces: dict = {}


def _workspace(dev, plan):
    key = (dev, plan["grid"], plan["workspace_floats"])
    ws = _workspaces.get(key)
    if ws is None:
        ws = (torch.empty(plan["workspace_floats"], dtype=torch.float32, device=dev),
              torch.zeros(plan["counters"], dtype=torch.int32, device=dev))
        _workspaces[key] = ws
    return ws


def _launch(name, fn_name, query, key_cache, value_cache, final_len, dec_start, write_end,
            scales=()):
    b, kv, g, d = query.shape
    s = key_cache.shape[2]
    plan = launch_plan(b, kv, g, s, d, bool(scales))
    _checks.shape(name, key_cache, (b, kv, s, d))
    _checks.shape(name, value_cache, (b, kv, s, d))
    _checks.shape(name, final_len, (b,))
    _checks.shape(name, dec_start, (b,))
    for sc in scales:
        _checks.shape(name, sc, (b, kv, s))
    for t in (query, key_cache, value_cache, *scales):
        if t.data_ptr() % 16:  # TMA and bulk copies read from 16-byte-aligned addresses
            raise ValueError(f"{name}: tensors must start on a 16-byte boundary")
    if not isinstance(write_end, int):
        raise TypeError(f"{name}: write_end must be a host int on CUDA")
    work, counters = _workspace(query.device, plan)
    out = torch.empty(b * kv * g * (d + 2), dtype=torch.float32, device=query.device)
    rc = getattr(_build.library(), fn_name)(
        query.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
        *(sc.data_ptr() for sc in scales),
        final_len.data_ptr(), dec_start.data_ptr(), work.data_ptr(), counters.data_ptr(),
        out.data_ptr(), b, kv, g, s, d, write_end, _build.stream_of(query),
    )
    _build.check(rc, name)
    n = b * kv * g
    return (out.as_strided((b, kv, g, d), (kv * g * d, g * d, d, 1)),
            out.as_strided((b, kv, g), (kv * g, g, 1), n * d),
            out.as_strided((b, kv, g), (kv * g, g, 1), n * (d + 1)))


def decode_gapped_flash_state(
    query: torch.Tensor,  # [B, KV, G, D] current-token queries (RoPE'd)
    key_cache: torch.Tensor,  # [B, KV, S, D] (int8 with k_scale)
    value_cache: torch.Tensor,
    final_len: torch.Tensor,  # [B] int32 (device tensor on CUDA)
    dec_start: torch.Tensor,  # [B] int32
    write_end,  # host int on CUDA (int or 0-d tensor on CPU)
    k_scale=None,  # [B, KV, S] f32: int8-KV mode
    v_scale=None,
):
    """Unnormalized flash state (acc, m, l) over each slot's live columns."""
    if query.device.type == "cpu":
        return decode_gapped_flash_state_plain(
            query, key_cache, value_cache, final_len, dec_start, write_end, k_scale, v_scale
        )
    if k_scale is not None:
        return decode_gapped_flash_state_int8(
            query, key_cache, value_cache, final_len, dec_start, write_end, k_scale, v_scale
        )
    name = "decode_gapped_flash_state"
    _checks.on_cuda(name, query, key_cache, value_cache, final_len, dec_start)
    _checks.dtype(name, torch.bfloat16, query, key_cache, value_cache)
    _checks.dtype(name, torch.int32, final_len, dec_start)
    out = _launch(name, "retake_decode_gapped_bf16", query, key_cache, value_cache,
                  final_len, dec_start, write_end)
    decode_gapped_flash_state.launches += 1
    return out


def decode_gapped_flash_state_int8(
    query, key_cache, value_cache, final_len, dec_start, write_end, k_scale, v_scale
):
    """K4's int8-KV mode on CUDA (see the module docstring)."""
    name = "decode_gapped_flash_state_int8"
    _checks.on_cuda(name, query, key_cache, value_cache, k_scale, v_scale, final_len, dec_start)
    _checks.dtype(name, torch.bfloat16, query)
    _checks.dtype(name, torch.int8, key_cache, value_cache)
    _checks.dtype(name, torch.float32, k_scale, v_scale)
    _checks.dtype(name, torch.int32, final_len, dec_start)
    out = _launch(name, "retake_decode_gapped_int8", query, key_cache, value_cache,
                  final_len, dec_start, write_end, (k_scale, v_scale))
    decode_gapped_flash_state_int8.launches += 1
    return out


decode_gapped_flash_state.launches = 0
decode_gapped_flash_state_int8.launches = 0
