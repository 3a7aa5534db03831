"""Chunked-prefill inference engine for Qwen2-VL, the ReTaKe runtime
(port of ``retake_tpu/runtime/engine.py``, sequential ``generate``).

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

Not ported yet (raise NotImplementedError): images, sampling, prompt-guided
compression, prefix / feature reuse across questions, speculative decode,
int8 / W8A8 quantization and the int8 KV cache, ``attn_implementation:
flash``, tensor parallelism, batched decode and serving, MA-LLM.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import numpy as np
import torch

from retake_tpu_torch import device as device_lib
from retake_tpu_torch.models.qwen2_vl import text
from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.ops import dpselect
from retake_tpu_torch.runtime import cache as cache_lib
from retake_tpu_torch.utils import positions as pos_lib
from retake_tpu_torch.utils.config import RetakeConfig
from retake_tpu_torch.utils.profiling import StageTimer

TEXT_BUCKET = 128  # text segments padded to a multiple of this
BUDGET_BUCKET = 8192  # cache budgets rounded up to a multiple of this


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
        if retake.quantization or retake.kv_cache_dtype:
            raise _not_ported("int8 / W8A8 quantization and the int8 KV cache")
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

    # ---------- vision ----------

    def run_vision(self, pixel_values_videos, video_grid_thw) -> torch.Tensor:
        """ViT over the video in frame chunks (reference qwen2_vl.py:597-617).

        pixel_values_videos: [grid_t*grid_h*grid_w, patch_dim] (numpy or
        tensor). Returns merged LLM-space embeddings [grid_t*h*w/4, d].
        """
        t, h, w = (int(x) for x in np.asarray(video_grid_thw).reshape(-1)[:3])
        fcs = self.retake.frame_chunk_size or 10**9
        patches = torch.as_tensor(pixel_values_videos).to(self.device, self.model.dtype)
        visual = self.model.visual
        if t <= fcs:
            return visual(patches, t, h, w, self.attn_impl)
        hw = h * w
        merged_per_t = hw // self.cfg.vision.spatial_merge_size**2
        out_buf = None
        for i in range(0, t, fcs):
            tc = min(fcs, t - i)
            chunk = patches[i * hw : (i + tc) * hw]
            if tc < fcs:  # pad the tail to the common shape; frames are independent
                chunk = torch.nn.functional.pad(chunk, (0, 0, 0, (fcs - tc) * hw))
            out = visual(chunk, fcs, h, w, self.attn_impl)
            if out_buf is None:
                out_buf = torch.empty(
                    (t * merged_per_t, out.shape[-1]), dtype=out.dtype, device=out.device
                )
            out_buf[i * merged_per_t : (i + tc) * merged_per_t] = out[: tc * merged_per_t]
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

    def encode_video(self, pixel_values_videos, video_grid_thw, _timer=None) -> VideoFeatures:
        """Vision tower + DPSelect keyframe selection."""
        timer = _timer or StageTimer()
        cfg, rt = self.cfg, self.retake
        t, h, w = (int(x) for x in np.asarray(video_grid_thw).reshape(-1)[:3])
        with timer.stage("vision_tower"):
            video_embeds = self.run_vision(pixel_values_videos, (t, h, w))
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

    def generate(
        self,
        input_ids: np.ndarray,
        pixel_values_videos=None,
        video_grid_thw=None,
        max_new_tokens: Optional[int] = None,
        pixel_values=None,
        image_grid_thw=None,
        video_features: Optional[VideoFeatures] = None,
    ) -> GenerationResult:
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
            vf = self.encode_video(pixel_values_videos, grid[0], _timer=timer)
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
) -> GenerationResult:
    """Chunked prefill over one static cache budget, then greedy decode."""
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
        dtype=embeds.dtype, device=device,
    )

    hidden = None
    with timer.stage("prefill_chunks"):
        for i, step in enumerate(plan):
            off, n = step["offset"], step["chunk_len"]
            hidden, kv = text.decoder_chunk(
                model, cfg, kv, embeds[off : off + n], pos_dev[:, off : off + n],
                lens_dev[i, 0], kp_dev[off : off + n], lens_dev[i, 1],
                compress=step["kind"] == "video" and compress_video,
                reforge=reforge, attn_impl=attn_impl,
            )
    last_valid = plan[-1]["valid"]

    with timer.stage("first_token"):
        logits = text.final_logits(model, cfg, hidden[last_valid - 1])
        token = torch.argmax(logits).reshape(1)
        token_host = int(token)  # prefill ends when the first token is ready
    t_prefill = time.perf_counter() - t_start
    cache_fill = int(kv.length)
    first_logits = logits.cpu().numpy()

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
