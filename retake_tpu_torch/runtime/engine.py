"""Chunked-prefill inference engine for Qwen2-VL, the ReTaKe runtime
(port of ``retake_tpu/runtime/engine.py``: sequential ``generate``, the
prefill-only split and batched decode over the gap-layout cache).

  host (numpy, once per request)           device (torch, eager)
  ---------------------------------        ---------------------------------
  get_rope_index                           ViT frame chunks (padded tail)
  DPSelect reforge of ids/positions        DPSelect scoring (+ gather)
  modality segmentation                    embed + video concat
  chunk plan: every keep_len/cache_len     text-segment steps (bucketed pad)
    is host-computable because the         video chunk steps (compress +
    compression ratio is fixed before        evict in every layer)
    prefill                                greedy decode steps
  one static cache budget

The plan's per-step lengths go to the device once, as one int32 table, and
the cache length stays on the device, so chunk steps run without host
reads; the host waits only for the first token and (with early stop) for
each decoded token one step late.

Batched decode (``generate_batch`` / ``decode_batch``; the continuous server
in ``runtime/serve.py``) prefills each request alone (``generate(...,
_prefill_only=True)`` -> ``PrefillState``), copies the caches into one
``[L, B, KV, S, D]`` gap-layout buffer and decodes all slots together:
every slot's step-i token is written at the shared column ``gap_start + i``
(a host int, so the append needs no device read).

int8 (``RetakeConfig.quantization`` / ``kv_cache_dtype``): the engine runs
whatever weights the model holds; int8 linears (``quantize_llm_int8`` /
``quantize_vit_int8``) run weight-only, or W8A8 at prefill under
``quantization: w8a8`` (decode stays weight-only). ``kv_cache_dtype: int8``
keeps the KV cache int8 with per-key scales, in the single-request cache,
the trimmed ``PrefillState`` cache and the gap-layout batch.

Not ported yet (raise NotImplementedError): images, sampling, prompt-guided
compression, prefix / feature reuse across questions, speculative decode,
``attn_implementation: flash``, tensor parallelism, MA-LLM.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import List, Optional

import numpy as np
import torch

from retake_tpu_torch import device as device_lib
from retake_tpu_torch.models.qwen2_vl import text
from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.ops import dpselect
from retake_tpu_torch.ops import quantization as q8
from retake_tpu_torch.runtime import cache as cache_lib
from retake_tpu_torch.utils import positions as pos_lib
from retake_tpu_torch.utils.config import RetakeConfig
from retake_tpu_torch.utils.profiling import StageTimer

TEXT_BUCKET = 128  # text segments padded to a multiple of this
BUDGET_BUCKET = 8192  # cache budgets rounded up to a multiple of this


def _attn_bucket(fill: int) -> int:
    """Attention-window bucket covering a given cache fill level."""
    return max(BUDGET_BUCKET, math.ceil(fill / BUDGET_BUCKET) * BUDGET_BUCKET)


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # generated token ids (without the prompt)
    prefill_seconds: float = 0.0  # request start -> first token on the host
    decode_seconds: float = 0.0
    cache_len: int = 0  # the host plan's final cache length
    input_len: int = 0
    cache_fill: int = 0  # the device cache length after prefill
    first_logits: Optional[np.ndarray] = None  # fp32 [V] logits of token 1
    cache: Optional[cache_lib.KVCache] = None  # the request's KV cache at its end
    stages: Optional[dict] = None  # per-stage seconds (RETAKE_PROFILE=1)


@dataclasses.dataclass
class VideoFeatures:
    """Question-independent vision output: LLM-space embeddings and the
    DPSelect keypatch mask."""

    embeds: torch.Tensor
    keymask: np.ndarray
    t: int
    tgt: int
    hw: int
    grid: tuple


@dataclasses.dataclass
class PrefillState:
    """Everything batched decode needs from one request's prefill."""

    cache: Optional[cache_lib.KVCache]  # consumed (set to None) by batched decode
    first_token_host: int
    decode_pos_base: int
    final_len: int
    reforge: bool
    result: GenerationResult  # prefill-only result (tokens = [first])
    # the attention bucket this request decodes in (_attn_bucket(final_len +
    # max_new)); the cache is trimmed to it, so pending requests hold their
    # own need, not a full prefill budget each
    attn_need: int = 0


def _trim_cache(cache: cache_lib.KVCache, need: int) -> cache_lib.KVCache:
    """Copy a prefilled cache down to its decode bucket, so the full prefill
    budget is freed (a view would keep it alive)."""
    scales = {}
    if cache.quantized:
        scales = dict(k_scale=cache.k_scale[:, :, :need].clone(),
                      v_scale=cache.v_scale[:, :, :need].clone())
    return cache_lib.KVCache(
        k=cache.k[:, :, :need].clone(),
        v=cache.v[:, :, :need].clone(),
        pos=cache.pos[:, :, :need].clone(),
        length=cache.length,
        **scales,
    )


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to retake_tpu_torch yet")


class Qwen2VLEngine:
    """Single-request (batch 1) long-video inference engine."""

    def __init__(
        self,
        cfg: Qwen2VLConfig,
        model: Qwen2VLModel,
        retake: RetakeConfig,
        device,
    ):
        self.device = device_lib.resolve(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        if retake.scaling_factor:
            cfg = cfg.with_yarn(retake.scaling_factor)
        impl = retake.attn_implementation
        if impl == "flash":
            raise _not_ported("attn_implementation 'flash'")
        if retake.do_sample:
            raise _not_ported("do_sample")
        if retake.spec_decode:
            raise _not_ported("spec_decode")
        if retake.kvcache_compression and retake.kv.prompt_guided_compression:
            raise _not_ported("prompt_guided_compression")
        if retake.visual_compression and retake.visual.compression_method != "Keyframe":
            raise _not_ported(f"visual compression {retake.visual.compression_method}")
        self.cfg = cfg
        self.model = model
        self.retake = retake
        self.attn_impl = impl if impl in ("pallas", "xla") else "pallas"
        # W8A8: prefill linears int8 x int8, only where the weights are int8
        self.act_quant = retake.quantization == "w8a8"

    # ---------- vision ----------

    def run_vision(self, pixel_values_videos, video_grid_thw, on_dispatch=None) -> torch.Tensor:
        """ViT over the video in frame chunks (reference qwen2_vl.py:597-617).

        pixel_values_videos: [grid_t*grid_h*grid_w, patch_dim] (numpy or
        tensor). Returns merged LLM-space embeddings [grid_t*h*w/4, d].
        ``on_dispatch`` (if given) is called after each chunk is enqueued:
        the continuous server runs decode segments there (runtime/serve.py).
        """
        t, h, w = (int(x) for x in np.asarray(video_grid_thw).reshape(-1)[:3])
        fcs = self.retake.frame_chunk_size or 10**9
        visual = self.model.visual
        patches = torch.as_tensor(pixel_values_videos).to(self.device, visual.dtype)
        aq = self.act_quant and visual.int8
        if t <= fcs:
            return visual(patches, t, h, w, self.attn_impl, aq)
        hw = h * w
        merged_per_t = hw // self.cfg.vision.spatial_merge_size**2
        out_buf = None
        for i in range(0, t, fcs):
            tc = min(fcs, t - i)
            chunk = patches[i * hw : (i + tc) * hw]
            if tc < fcs:  # pad the tail to the common shape; frames are independent
                chunk = torch.nn.functional.pad(chunk, (0, 0, 0, (fcs - tc) * hw))
            out = visual(chunk, fcs, h, w, self.attn_impl, aq)
            if out_buf is None:
                out_buf = torch.empty(
                    (t * merged_per_t, out.shape[-1]), dtype=out.dtype, device=out.device
                )
            out_buf[i * merged_per_t : (i + tc) * merged_per_t] = out[: tc * merged_per_t]
            if on_dispatch is not None:
                on_dispatch()
        return out_buf

    def get_chunk_tokens(self, video_grid_thw) -> Optional[int]:
        """Tokens per LLM prefill chunk (chunked_prefill_frames is in raw
        frames)."""
        chunk_frames = self.retake.chunked_prefill_frames
        if chunk_frames is None:
            return None
        t, h, w = (int(x) for x in np.asarray(video_grid_thw).reshape(-1)[:3])
        vf = self.cfg.vision
        t_factor = vf.spatial_merge_size**2 * vf.temporal_patch_size
        return min(chunk_frames, t) * h * w // t_factor

    def encode_video(
        self, pixel_values_videos, video_grid_thw, on_dispatch=None, _timer=None
    ) -> VideoFeatures:
        """Vision tower + DPSelect keyframe selection."""
        timer = _timer or StageTimer()
        cfg, rt = self.cfg, self.retake
        t, h, w = (int(x) for x in np.asarray(video_grid_thw).reshape(-1)[:3])
        with timer.stage("vision_tower"):
            video_embeds = self.run_vision(pixel_values_videos, (t, h, w), on_dispatch)
        hw_m = h * w // cfg.vision.spatial_merge_size**2
        tgt = t
        keymask_np = np.zeros(t * hw_m, bool)
        if rt.visual_compression:
            with timer.stage("dpselect"):
                vc = rt.visual
                tgt = max(1, round(vc.compression_ratio * t))
                bank = video_embeds.reshape(t, hw_m, -1)
                keep, keymask = dpselect.dpselect(bank, tgt, 3, vc.patch_sync)
                if tgt != t:  # ratio 1.0 keeps every frame: mask only
                    video_embeds = dpselect.gather_keyframes(bank, keep).reshape(tgt * hw_m, -1)
                if vc.patch_sync:
                    keymask = keymask[:, None].expand(tgt, hw_m)
                keymask_np = (
                    keymask.reshape(-1).cpu().numpy()
                    if vc.return_keyframe_mask
                    else np.zeros(tgt * hw_m, bool)
                )
        return VideoFeatures(
            embeds=video_embeds, keymask=keymask_np, t=t, tgt=tgt, hw=hw_m, grid=(t, h, w)
        )

    # ---------- prefill + decode ----------

    def generate_batch(
        self, requests: List[dict], max_new_tokens: Optional[int] = None
    ) -> List[GenerationResult]:
        """Serve several requests: sequential prefill, batched decode.

        Each request is a dict of ``generate`` kwargs and may carry its own
        ``max_new_tokens``: the batch decodes the largest budget and each
        slot stops at its own (``decode_batch`` with ``req_max``), so every
        result is token-exact against sequential ``generate``. Decode runs
        the plain attention arm (``decode_batch``'s default), as in the JAX
        engine."""
        if not requests:
            return []
        if self.attn_impl == "xla":
            warnings.warn(
                "generate_batch with attn_implementation 'xla': batched decode uses "
                "the gap-layout attention, whose fp32 sums run in another order than "
                "the sequential 'xla' decode, so tokens may differ at near-ties",
                stacklevel=2,
            )
        default_max = max_new_tokens or self.retake.max_new_tokens
        req_max = [int(req.get("max_new_tokens") or default_max) for req in requests]
        batch_max = max(req_max)
        states = [
            self.generate(
                **{k: v for k, v in req.items() if k != "max_new_tokens"},
                max_new_tokens=batch_max, _prefill_only=True,
            )
            for req in requests
        ]
        results = decode_batch(
            self.model, self.cfg, self.retake, states, batch_max,
            early_stop=bool(self.retake.decode_early_stop), req_max=req_max,
        )
        for res, m in zip(results, req_max):
            res.tokens = res.tokens[:m]
        return results

    def generate(
        self,
        input_ids: np.ndarray,
        pixel_values_videos=None,
        video_grid_thw=None,
        max_new_tokens: Optional[int] = None,
        pixel_values=None,
        image_grid_thw=None,
        video_features: Optional[VideoFeatures] = None,
        _prefill_only: bool = False,
        on_dispatch=None,  # serving hook: called after each ViT chunk and plan step
    ):
        """One request: prefill and greedy decode -> ``GenerationResult``;
        with ``_prefill_only`` the prefill's ``PrefillState`` instead."""
        if pixel_values is not None or image_grid_thw is not None:
            raise _not_ported("image inputs (run_vision_images)")
        if video_features is not None:
            raise _not_ported("video feature reuse")
        timer = StageTimer()
        cfg = self.cfg
        max_new_tokens = max_new_tokens or self.retake.max_new_tokens
        ids = np.asarray(input_ids, dtype=np.int64).reshape(-1)

        t0 = time.perf_counter()
        grid = None if video_grid_thw is None else np.asarray(video_grid_thw).reshape(-1, 3)
        pos, _ = pos_lib.get_rope_index(
            ids,
            spatial_merge_size=cfg.vision.spatial_merge_size,
            image_token_id=cfg.image_token_id,
            video_token_id=cfg.video_token_id,
            vision_start_token_id=cfg.vision_start_token_id,
            video_grid_thw=grid,
        )
        decode_pos_base = int(pos.max()) + 1

        video_embeds = None
        keypatch_tokens = np.zeros(len(ids), dtype=bool)
        if pixel_values_videos is not None:
            vf = self.encode_video(pixel_values_videos, grid[0], on_dispatch, _timer=timer)
            video_embeds = vf.embeds
            if vf.tgt != vf.t:
                vi = np.where(ids == cfg.video_token_id)[0]
                ids, pos = pos_lib.reforge_after_visual_compression(
                    ids, pos, (int(vi[0]), int(vi[-1]) + 1), vf.tgt * vf.hw, vf.t - vf.tgt
                )
                keypatch_tokens = np.zeros(len(ids), dtype=bool)
            vi = np.where(ids == cfg.video_token_id)[0]
            keypatch_tokens[vi[0] : vi[0] + len(vf.keymask)] = vf.keymask

        chunk_tokens = self.get_chunk_tokens(grid[0]) if grid is not None else None
        return prefill_and_decode(
            self.model, cfg, self.retake,
            ids=ids, pos=pos, keypatch_tokens=keypatch_tokens,
            video_embeds=video_embeds, video_token_id=cfg.video_token_id,
            chunk_tokens=chunk_tokens, decode_pos_base=decode_pos_base,
            max_new_tokens=max_new_tokens, attn_impl=self.attn_impl,
            timer=timer, t_start=t0, device=self.device,
            prefill_only=_prefill_only, on_dispatch=on_dispatch,
            act_quant=self.act_quant and self.model.int8,
        )


def plan_chunks(
    ids: np.ndarray,
    video_token_id: int,
    chunk_tokens: Optional[int],
    ratio: float,
    compress_video: bool,
) -> tuple:
    """Host plan: (steps, final cache length, max write extent). Each step
    is a dict with kind, offset, valid, chunk_len, keep and cache_len."""
    s = len(ids)
    if chunk_tokens is None:
        segments = [(0, s, "text")]
    else:
        segments = pos_lib.segment_modalities(ids, video_token_id)
    plan: List[dict] = []
    cache_len = 0
    max_extent = 0
    for seg_s, seg_e, kind in segments:
        n = seg_e - seg_s
        if kind == "text":
            padded = max(TEXT_BUCKET, math.ceil(n / TEXT_BUCKET) * TEXT_BUCKET)
            plan.append(dict(kind="text", offset=seg_s, valid=n, chunk_len=padded,
                             keep=n, cache_len=cache_len))
            max_extent = max(max_extent, cache_len + padded)
            cache_len += n
            continue
        for ci in range(math.ceil(n / chunk_tokens)):
            ss = seg_s + ci * chunk_tokens
            valid = min(chunk_tokens, seg_e - ss)
            keep = max(1, int(ratio * valid)) if compress_video else valid
            plan.append(dict(kind="video", offset=ss, valid=valid, chunk_len=chunk_tokens,
                             keep=keep, cache_len=cache_len))
            max_extent = max(max_extent, cache_len + chunk_tokens)
            cache_len += keep
    return plan, cache_len, max_extent


def prefill_and_decode(
    model: Qwen2VLModel,
    cfg: Qwen2VLConfig,
    rt: RetakeConfig,
    *,
    ids: np.ndarray,
    pos: np.ndarray,  # [3, S] int32
    keypatch_tokens: np.ndarray,
    video_embeds: Optional[torch.Tensor],
    video_token_id: int,
    chunk_tokens: Optional[int],
    decode_pos_base: int,
    max_new_tokens: int,
    attn_impl: str,
    timer: StageTimer,
    t_start: float,
    device: torch.device,
    prefill_only: bool = False,
    on_dispatch=None,  # called after each plan step is enqueued (serving hook)
    act_quant: bool = False,  # W8A8 prefill linears (int8 weights)
):
    """Chunked prefill over one static cache budget, then greedy decode
    (or, with ``prefill_only``, the ``PrefillState`` for batched decode).
    An int8 KV cache (``kv_cache_dtype: int8``) takes each decode token
    quantized per key."""
    s = len(ids)
    ratio = rt.compression_ratio_for(s)
    reforge = rt.kv.pos_embed_reforge and rt.kvcache_compression
    compress_video = rt.kvcache_compression and ratio < 1.0

    plan, final_len, max_extent = plan_chunks(
        ids, video_token_id, chunk_tokens, ratio, compress_video
    )
    needed = max(max_extent, final_len + max_new_tokens)
    budget = math.ceil(needed / BUDGET_BUCKET) * BUDGET_BUCKET

    # device inputs: ids/positions/keypatch padded to the plan's extent, and
    # every step's (valid_len, keep_len) in one table
    s_pad = max(max(p["offset"] + p["chunk_len"] for p in plan), s)
    ids_pad = np.zeros(s_pad, dtype=np.int64)
    ids_pad[:s] = ids
    pos_pad = np.zeros((3, s_pad), dtype=np.int32)
    pos_pad[:, :s] = pos
    if s_pad > s:  # continue positions into padding (masked anyway)
        pos_pad[:, s:] = pos[:, -1:] + np.arange(1, s_pad - s + 1)
    kp_pad = np.zeros(s_pad, dtype=bool)
    kp_pad[:s] = keypatch_tokens
    ids_dev = torch.from_numpy(ids_pad).to(device)
    pos_dev = torch.from_numpy(pos_pad).to(device)
    kp_dev = torch.from_numpy(kp_pad).to(device)
    lens_dev = torch.tensor(
        [[p["valid"], p["keep"]] for p in plan] + [[1, 1]], dtype=torch.int32
    ).to(device)

    if video_embeds is not None:
        n_video_tokens = int(np.sum(ids == video_token_id))
        if n_video_tokens != video_embeds.shape[0]:
            raise ValueError(
                "Video features and video tokens do not match: tokens: "
                f"{n_video_tokens}, features {video_embeds.shape[0]}"
            )
        vstart = int(np.where(ids == video_token_id)[0][0])
        if not np.all(ids[vstart : vstart + n_video_tokens] == video_token_id):
            raise NotImplementedError("multiple non-contiguous video token spans in one prompt")
        embeds = torch.cat([
            text.embed(model, ids_dev[:vstart]),
            video_embeds.to(model.dtype),
            text.embed(model, ids_dev[vstart + n_video_tokens :]),
        ])
    else:
        embeds = text.embed(model, ids_dev)
    video_embeds = None

    kv = cache_lib.init_cache(
        cfg.num_hidden_layers, cfg.num_key_value_heads, budget, cfg.head_dim,
        dtype=embeds.dtype, device=device, quantized=rt.kv_cache_dtype == "int8",
    )

    hidden = None
    with timer.stage("prefill_chunks"):
        for i, step in enumerate(plan):
            off, n = step["offset"], step["chunk_len"]
            hidden, kv = text.decoder_chunk(
                model, cfg, kv, embeds[off : off + n], pos_dev[:, off : off + n],
                lens_dev[i, 0], kp_dev[off : off + n], lens_dev[i, 1],
                compress=step["kind"] == "video" and compress_video,
                reforge=reforge, attn_impl=attn_impl, act_quant=act_quant,
            )
            if on_dispatch is not None:
                on_dispatch()
    last_valid = plan[-1]["valid"]

    with timer.stage("first_token"):
        logits = text.final_logits(model, cfg, hidden[last_valid - 1])
        token = torch.argmax(logits).reshape(1)
        token_host = int(token)  # prefill ends when the first token is ready
    t_prefill = time.perf_counter() - t_start
    cache_fill = int(kv.length)
    first_logits = logits.cpu().numpy()

    if prefill_only:
        timer.report()
        result = GenerationResult(
            tokens=np.asarray([token_host]), prefill_seconds=t_prefill, cache_len=final_len,
            input_len=s, cache_fill=cache_fill, first_logits=first_logits,
            stages=dict(timer.totals) if timer.totals else None,
        )
        need = min(_attn_bucket(final_len + max_new_tokens), budget)
        if need < budget:
            kv = _trim_cache(kv, need)
        return PrefillState(
            cache=kv, first_token_host=token_host, decode_pos_base=decode_pos_base,
            final_len=final_len, reforge=reforge, result=result, attn_need=need,
        )

    # decode: greedy; with early stop the host checks each token one step
    # late, so it never waits on the step it is enqueuing
    t0 = time.perf_counter()
    out_tokens = [token_host]
    eos = cfg.eos_token_id
    if max_new_tokens > 1 and token_host != eos:
        early_stop = bool(rt.decode_early_stop)
        one = lens_dev[-1, 0]
        no_keypatch = torch.zeros(1, dtype=torch.bool, device=device)
        pos_base = torch.full((3, 1), decode_pos_base, dtype=torch.int32, device=device)
        steps = []
        with timer.stage("decode"):
            for i in range(max_new_tokens - 1):
                hidden, kv = text.decoder_chunk(
                    model, cfg, kv, text.embed(model, token), pos_base + i,
                    one, no_keypatch, one, compress=False, reforge=reforge,
                    attn_impl=attn_impl,
                )
                token = torch.argmax(text.final_logits(model, cfg, hidden[0])).reshape(1)
                steps.append(token)
                if early_stop and len(steps) > 1 and int(steps[-2]) == eos:
                    break
            tokens = torch.cat(steps).cpu().numpy()
        hit = np.flatnonzero(tokens == eos)
        end = (hit[0] + 1) if len(hit) else len(tokens)
        out_tokens.extend(tokens[:end].tolist())
    t_decode = time.perf_counter() - t0

    timer.report()
    return GenerationResult(
        tokens=np.asarray(out_tokens),
        prefill_seconds=t_prefill,
        decode_seconds=t_decode,
        cache_len=final_len,
        input_len=s,
        cache_fill=cache_fill,
        first_logits=first_logits,
        cache=kv,
        stages=dict(timer.totals) if timer.totals else None,
    )


# ---------- batched decode over the gap-layout cache ----------


def _insert_batch_slot(buf: torch.Tensor, x: torch.Tensor, slot: int) -> None:
    """Write one request's cache ``x`` [L, KV, n, ...] into batch slot
    ``slot`` of ``buf`` [L, B, KV, S, ...] in place, zeroing the slot's
    columns past n (the JAX version writes a zero-padded copy). Serves the
    K/V buffers and the int8 scale planes [L, B, KV, S] alike."""
    n = x.shape[2]
    buf[:, slot, :, :n].copy_(x)
    buf[:, slot, :, n:].zero_()


def assemble_gap_cache(states: List[PrefillState], s_attn: int):
    """Gather prefilled caches into ``[L, B, KV, s_attn, D]`` key / value
    buffers (slot b = ``states[b]``, its prefill at ``[0, final_len)``), the
    per-layer temporal position bases [L, B] int32 (the reforged position
    after the slot's last cached token, or the request's decode position)
    and, for int8 caches, the scale planes [L, B, KV, s_attn] (else None):
    ``(k_all, v_all, base_t, ks_all, vs_all)``. Consumes each state's cache
    (``st.cache`` becomes None)."""
    c0 = states[0].cache
    n_layers, kv, _, d = c0.k.shape
    dev = c0.k.device
    k_all = torch.zeros((n_layers, len(states), kv, s_attn, d), dtype=c0.k.dtype, device=dev)
    v_all = torch.zeros_like(k_all)
    ks_all = vs_all = None
    if c0.quantized:
        ks_all = torch.zeros(k_all.shape[:4], dtype=torch.float32, device=dev)
        vs_all = torch.zeros_like(ks_all)
    bases = []
    for b, st in enumerate(states):
        c = st.cache
        n = min(c.k.shape[2], s_attn)
        _insert_batch_slot(k_all, c.k[:, :, :n], b)
        _insert_batch_slot(v_all, c.v[:, :, :n], b)
        if c0.quantized:
            _insert_batch_slot(ks_all, c.k_scale[:, :, :n], b)
            _insert_batch_slot(vs_all, c.v_scale[:, :, :n], b)
        if st.reforge:  # per-layer continuation after eviction (reference qwen2_vl.py:67-73)
            bases.append(c.pos[:, 0, st.final_len - 1] + 1)
        else:
            bases.append(torch.full((n_layers,), st.decode_pos_base, dtype=torch.int32, device=dev))
        st.cache = None
    return k_all, v_all, torch.stack(bases, dim=1).to(torch.int32), ks_all, vs_all


def _decode_loop_batch(
    model: Qwen2VLModel,
    cfg: Qwen2VLConfig,
    k_all: torch.Tensor,  # [L, B, KV, S, D], written in place (int8 with ks_all)
    v_all: torch.Tensor,
    base_t: torch.Tensor,  # [L, B] int32
    pos_bases: torch.Tensor,  # [B] int32
    final_len: torch.Tensor,  # [B] int32
    gap_start: int,
    first_tokens: torch.Tensor,  # [B] int
    num_steps: int,
    sampling=None,
    dec_start=None,  # [B] int32 per-slot decode-region start; None = gap_start
    i0: int = 0,  # global decode steps taken before this call (write pointer)
    done0=None,  # [B] bool slots already finished or free; None = first == eos
    attn_impl: str = "xla",  # "pallas": K4; "xla": full-bucket masked softmax
    early_stop: bool = False,  # stop once every slot is done (checked one step late)
    max_steps=None,  # [B] int32 per-slot output budget (max_new_tokens - 1)
    ks_all=None,  # [L, B, KV, S] f32 scale planes of an int8 cache, written in place
    vs_all=None,
) -> torch.Tensor:
    """Greedy batched decode: ``num_steps`` steps for all B slots; returns
    the tokens [num_steps, B] (int64, on the device). Step i's K/V land at
    the shared column ``gap_start + i`` (quantized per key into an int8
    cache, their scales into the scale planes). A slot that is done emits
    EOS. With ``early_stop`` the host reads ``all(done)`` of the previous
    step while the current one is queued, so at most one step more than
    needed runs; the skipped rows stay EOS, as in the JAX while-loop."""
    if sampling is not None:
        raise _not_ported("sampling in batched decode")
    eos = cfg.eos_token_id
    tokens = first_tokens.to(torch.int64)
    done = (tokens == eos) if done0 is None else done0.to(torch.bool)
    out = torch.full((num_steps, tokens.shape[0]), eos, dtype=torch.int64, device=tokens.device)
    prev_done = None
    for j in range(num_steps):
        i = i0 + j
        hidden, kb, vb = text.decode_step_batch(
            model, cfg, k_all, v_all, text.embed(model, tokens), base_t, pos_bases + i,
            final_len, gap_start, i, dec_start=dec_start, attn_impl=attn_impl,
            ks_all=ks_all, vs_all=vs_all,
        )
        nxt = torch.argmax(text.final_logits_batch(model, cfg, hidden), dim=-1)
        nxt = torch.where(done, eos, nxt)
        done = done | (nxt == eos)
        if max_steps is not None:
            done = done | (i + 1 >= max_steps)
        if ks_all is not None:  # [L, B, KV, D] -> int8 + [L, B, KV] scales
            kb, kbs = q8.quantize_kv_block(kb)
            vb, vbs = q8.quantize_kv_block(vb)
            ks_all[:, :, :, gap_start + i] = kbs
            vs_all[:, :, :, gap_start + i] = vbs
        k_all[:, :, :, gap_start + i] = kb.to(k_all.dtype)
        v_all[:, :, :, gap_start + i] = vb.to(v_all.dtype)
        out[j] = nxt
        tokens = nxt
        if early_stop and prev_done is not None and bool(prev_done.all()):
            break
        prev_done = done
    return out


def decode_batch(
    model: Qwen2VLModel,
    cfg: Qwen2VLConfig,
    rt: RetakeConfig,
    states: List[PrefillState],
    max_new_tokens: int,
    attn_impl: str = "xla",  # the plain arm, as in the JAX engine's decode_batch
    early_stop: bool = False,
    req_max: Optional[List[int]] = None,  # per-request total token budgets
) -> List[GenerationResult]:
    """Batched greedy decode over prefilled requests (``generate_batch``).
    Requests whose first token is EOS do not join the batch; the others
    share the decode region starting at their largest ``final_len``."""
    if not states:
        return []
    if any(st.reforge != states[0].reforge for st in states):
        raise ValueError("decode_batch: mixed reforge settings across prefill states")
    t0 = time.perf_counter()
    eos = cfg.eos_token_id
    out_tokens = [[st.first_token_host] for st in states]
    live = [i for i, st in enumerate(states) if st.first_token_host != eos]
    if max_new_tokens > 1 and live:
        gap_start = max(states[i].final_len for i in live)
        k_all, v_all, base_t, ks_all, vs_all = assemble_gap_cache(
            [states[i] for i in live], _attn_bucket(gap_start + max_new_tokens)
        )
        dev = k_all.device

        def dev_vec(xs, dtype):
            return torch.tensor(xs, dtype=dtype).to(dev)

        max_steps = None
        if req_max is not None:
            max_steps = dev_vec([int(req_max[i]) - 1 for i in live], torch.int32)
        tokens = _decode_loop_batch(
            model, cfg, k_all, v_all, base_t,
            dev_vec([states[i].decode_pos_base for i in live], torch.int32),
            dev_vec([states[i].final_len for i in live], torch.int32), gap_start,
            dev_vec([states[i].first_token_host for i in live], torch.int64),
            max_new_tokens - 1, attn_impl=attn_impl, early_stop=early_stop,
            max_steps=max_steps, ks_all=ks_all, vs_all=vs_all,
        ).cpu().numpy()
        del k_all, v_all, ks_all, vs_all
        for bi, i in enumerate(live):
            col = tokens[:, bi]
            hit = np.flatnonzero(col == eos)
            out_tokens[i].extend(col[: (hit[0] + 1) if len(hit) else len(col)].tolist())
    for st in states:
        st.cache = None
    t_decode = time.perf_counter() - t0
    return [
        GenerationResult(
            tokens=np.asarray(out_tokens[i]),
            prefill_seconds=st.result.prefill_seconds,
            decode_seconds=t_decode,  # the shared batched-decode wall time
            cache_len=st.result.cache_len,
            input_len=st.result.input_len,
            cache_fill=st.result.cache_fill,
            first_logits=st.result.first_logits,
            stages=st.result.stages,
        )
        for i, st in enumerate(states)
    ]
