"""Chunked-prefill inference engine for Qwen2-VL, the ReTaKe runtime
(port of ``retake_tpu/runtime/engine.py``: ``generate`` with video, image
and mixed prompts, the prefill-only split, batched decode over the
gap-layout cache, reuse of a video's features and prefill across
questions, greedy, sampled and speculative decode).

  host (numpy, once per request)           device (torch, eager)
  ---------------------------------        ---------------------------------
  get_rope_index                           ViT frame chunks (padded tail),
  DPSelect reforge of ids/positions          one ViT pass per still image
  modality segmentation                    DPSelect scoring (+ gather)
  chunk plan: every keep_len/cache_len     embed + video concat + image spans
    is host-computable because the         text-segment steps (bucketed pad)
    compression ratio is fixed before      video chunk steps (compress +
    prefill                                  evict in every layer; with
  one static cache budget                    prompt-guided compression the
                                             question rides in every chunk)
                                           greedy / sampled / speculative
                                             decode steps

The plan's per-step lengths go to the device once, as one int32 table, and
the cache length stays on the device, so chunk steps run without host
reads; the host waits only for the first token and (with early stop) for
each decoded token one step late. Speculative decode (``spec_decode``) is
a host loop over verify steps: each reads its verdicts back, and a
rejected proposal rolls the cache back by its length only.

Sampling (``do_sample``, ``runtime/sampling.py``) draws with Gumbel noise
seeded from (``seed``, request-own step) alone, so a request samples the
same tokens sequentially, in ``generate_batch`` and in the server.

Reuse across questions about one video: ``encode_video`` ->
``generate(video_features=...)`` skips the ViT and DPSelect;
``encode_prefix`` -> ``generate(prefix=...)`` also skips the video prefill
(the KV cache after the last video chunk is forked per question), and
raises ``PrefixMismatch`` when a question's plan diverges from the capture.

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
the trimmed ``PrefillState`` cache, a ``VideoPrefix`` and the gap-layout
batch.

``attn_implementation``: ``"pallas"`` runs the kernels (K1 and K2 in the
prefill, K3 in the ViT); ``"flash"`` is the blocked online-softmax chunk
attention in plain torch with the plain PivotKV scores, as the JAX package
has it, while the ViT still runs K3 (the JAX ViT always takes its kernel);
``"xla"`` is the plain path everywhere. Visual compression: DPSelect
(``Keyframe``), MA-LLM and MA-LLM-hard (``ops/dpselect.malm_compress``).

Not ported yet: tensor parallelism.
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
from retake_tpu_torch.ops.cuda import decode_gapped
from retake_tpu_torch.runtime import cache as cache_lib
from retake_tpu_torch.runtime.sampling import FIRST, LOOP, Sampler, select_tokens
from retake_tpu_torch.utils import positions as pos_lib
from retake_tpu_torch.utils.config import RetakeConfig
from retake_tpu_torch.utils.profiling import StageTimer

TEXT_BUCKET = 128  # text segments padded to a multiple of this
BUDGET_BUCKET = 8192  # cache budgets rounded up to a multiple of this
POOL_PROMPT = 256  # prompt-tail tokens the spec-decode matcher can see


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
    # speculative decode: (tokens emitted m, verify steps n_it); m / n_it is
    # the tokens per verify step (1.0 = no proposal ever accepted)
    spec_steps: Optional[tuple] = None


@dataclasses.dataclass
class VideoFeatures:
    """Question-independent vision output: LLM-space embeddings and the
    DPSelect keypatch mask. ``t`` / ``tgt``: temporal-merged frame counts
    before / after DPSelect; ``hw``: merged tokens per frame; ``grid``: the
    raw (t, h, w) patch grid."""

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


class PrefixMismatch(ValueError):
    """``generate(prefix=...)`` got a question whose prefill plan diverges
    from the captured prefix (another prompt prefix, or a dynamic
    compression ratio that resolved to other keep lengths). Fall back to
    ``generate(video_features=prefix.features)``."""


class PrefixBudgetOverflow(PrefixMismatch):
    """The captured prefix's cache budget is too small for this question
    (more new tokens or a longer question than the capture reserved): a
    capture with a larger ``reserve_tokens`` fixes it."""


class PrefixUnsupported(ValueError):
    """No question-independent prefill exists under this engine config
    (prompt-guided compression folds the question into every video chunk)."""


@dataclasses.dataclass
class VideoPrefix:
    """The compressed KV cache after a video's last chunk, reusable for every
    question about that video whose plan up to there is the same
    (``generate(prefix=...)`` forks it, so it is never written)."""

    cache: cache_lib.KVCache
    final_len: int  # cache fill after the prefix
    budget: int  # cache budget of the capture (reserve included)
    split: int  # index into the reforged ids where the prefix ends
    prefix_ids: np.ndarray  # reforged ids[:split]
    plan_sig: tuple  # ((kind, offset, valid, keep), ...) of the prefix steps
    features: Optional[VideoFeatures] = None  # vision metadata and the fallback
    prefill_seconds: float = 0.0  # capture time (vision + video prefill)
    stages: Optional[dict] = None


def _fork_cache(cache: cache_lib.KVCache) -> cache_lib.KVCache:
    """A device copy of a cache (k, v, pos, length and int8 scale planes):
    chunk steps write their cache in place."""
    return cache_lib.KVCache(**{
        f.name: None if getattr(cache, f.name) is None else getattr(cache, f.name).clone()
        for f in dataclasses.fields(cache)
    })


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


def batched_decode_impl(cfg: Qwen2VLConfig, device) -> str:
    """The batched-decode attention arm for a model on ``device``: K4
    (``"pallas"``) on CUDA when the GQA group fits the kernel, the plain
    arm (``"xla"``) otherwise."""
    group = cfg.num_attention_heads // cfg.num_key_value_heads
    on_cuda = torch.device(device).type == "cuda"
    return "pallas" if on_cuda and group <= decode_gapped.MAX_GROUP else "xla"


class Qwen2VLEngine:
    """Single-request (batch 1) long-video inference engine.

    ``noise_fn`` (None: ``sampling.gumbel_noise``) is the sampler's noise
    source under ``do_sample``; tests set it to feed known draws."""

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
        self.cfg = cfg
        self.model = model
        self.retake = retake
        self.attn_impl = impl if impl in ("flash", "pallas", "xla") else "pallas"
        # the ViT has one attention kernel (K3); only "xla" takes its plain twin
        self.vit_impl = "xla" if self.attn_impl == "xla" else "pallas"
        # W8A8: prefill linears int8 x int8, only where the weights are int8
        self.act_quant = retake.quantization == "w8a8"
        self.noise_fn = None

    @property
    def sampler(self) -> Optional[Sampler]:
        return Sampler.from_config(self.retake, self.noise_fn)

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
            return visual(patches, t, h, w, self.vit_impl, aq)
        hw = h * w
        merged_per_t = hw // self.cfg.vision.spatial_merge_size**2
        out_buf = None
        for i in range(0, t, fcs):
            tc = min(fcs, t - i)
            chunk = patches[i * hw : (i + tc) * hw]
            if tc < fcs:  # pad the tail to the common shape; frames are independent
                chunk = torch.nn.functional.pad(chunk, (0, 0, 0, (fcs - tc) * hw))
            out = visual(chunk, fcs, h, w, self.vit_impl, aq)
            if out_buf is None:
                out_buf = torch.empty(
                    (t * merged_per_t, out.shape[-1]), dtype=out.dtype, device=out.device
                )
            out_buf[i * merged_per_t : (i + tc) * merged_per_t] = out[: tc * merged_per_t]
            if on_dispatch is not None:
                on_dispatch()
        return out_buf

    def run_vision_images(self, pixel_values, image_grid_thw) -> torch.Tensor:
        """ViT over still images (reference qwen2_vl.py:593-595): each image
        is its own (t, h, w) grid; the embeddings concatenate in input
        order."""
        grids = np.asarray(image_grid_thw).reshape(-1, 3)
        visual = self.model.visual
        pixels = torch.as_tensor(pixel_values).to(self.device, visual.dtype)
        aq = self.act_quant and visual.int8
        outs = []
        off = 0
        for t, h, w in grids.tolist():
            n = t * h * w
            outs.append(visual(pixels[off : off + n], t, h, w, self.vit_impl, aq))
            off += n
        if off != pixels.shape[0]:
            raise ValueError(f"image grids cover {off} patches, pixel_values has {pixels.shape[0]}")
        return outs[0] if len(outs) == 1 else torch.cat(outs)

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
        """Vision tower + visual compression (DPSelect keyframes, or MA-LLM /
        MA-LLM-hard frame merging): the question-independent artifact
        ``generate(video_features=...)`` takes."""
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
                if vc.compression_method == "Keyframe":
                    keep, keymask = dpselect.dpselect(bank, tgt, 3, vc.patch_sync)
                    if tgt != t:  # ratio 1.0 keeps every frame: mask only
                        video_embeds = dpselect.gather_keyframes(bank, keep).reshape(
                            tgt * hw_m, -1)
                    if vc.patch_sync:
                        keymask = keymask[:, None].expand(tgt, hw_m)
                    keymask_np = (
                        keymask.reshape(-1).cpu().numpy()
                        if vc.return_keyframe_mask
                        else np.zeros(tgt * hw_m, bool)
                    )
                elif vc.compression_method in ("MA-LLM", "MA-LLM-hard"):
                    video_embeds = dpselect.malm_compress(
                        bank, tgt, sync=vc.patch_sync,
                        hard=vc.compression_method == "MA-LLM-hard",
                    ).reshape(tgt * hw_m, -1)
                    keymask_np = np.zeros(tgt * hw_m, bool)  # merged frames: no keypatches
                else:
                    raise NotImplementedError(vc.compression_method)
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
        result is token-exact against sequential ``generate``, sampled ones
        too (draws depend on the request-own step), up to the rounding of
        the decode attention: K4 on CUDA, the plain arm elsewhere (the JAX
        engine's ``decode_batch`` arm)."""
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
            attn_impl=batched_decode_impl(self.cfg, self.device),
            early_stop=bool(self.retake.decode_early_stop), req_max=req_max,
            sampler=self.sampler,
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
        video_features: Optional[VideoFeatures] = None,  # an encode_video artifact
        prefix: Optional[VideoPrefix] = None,  # an encode_prefix artifact
        _prefill_only: bool = False,
        _capture_reserve: Optional[int] = None,  # encode_prefix plumbing
        on_dispatch=None,  # serving hook: called after each ViT chunk and plan step
    ):
        """One request: prefill and decode -> ``GenerationResult``; with
        ``_prefill_only`` the prefill's ``PrefillState`` instead, with
        ``_capture_reserve`` the ``VideoPrefix``."""
        timer = StageTimer()
        cfg = self.cfg
        max_new_tokens = max_new_tokens or self.retake.max_new_tokens
        ids = np.asarray(input_ids, dtype=np.int64).reshape(-1)

        t0 = time.perf_counter()
        if prefix is not None:
            if pixel_values_videos is not None or video_features is not None:
                raise ValueError("generate(prefix=...) replaces both the pixels and the "
                                 "video_features inputs")
            # positions come from the captured grid: a prompt whose video span
            # differs from the capture fails here, before get_rope_index
            n_vid = int(np.sum(ids == cfg.video_token_id))
            n_expected = prefix.features.t * prefix.features.hw
            if n_vid != n_expected:
                raise PrefixMismatch(
                    f"prompt has {n_vid} video tokens but the captured prefix has {n_expected}"
                )
            video_grid_thw = np.asarray([prefix.features.grid])
        if pixel_values_videos is None and video_features is not None:
            video_grid_thw = np.asarray([video_features.grid])
        grid = None if video_grid_thw is None else np.asarray(video_grid_thw).reshape(-1, 3)
        igrid = None if image_grid_thw is None else np.asarray(image_grid_thw).reshape(-1, 3)
        pos, _ = pos_lib.get_rope_index(
            ids,
            spatial_merge_size=cfg.vision.spatial_merge_size,
            image_token_id=cfg.image_token_id,
            video_token_id=cfg.video_token_id,
            vision_start_token_id=cfg.vision_start_token_id,
            video_grid_thw=grid,
            image_grid_thw=igrid,
        )
        decode_pos_base = int(pos.max()) + 1

        # still images: one ViT pass each, scattered at the image-token spans
        # by prefill_and_decode; image tokens prefill as text segments
        image_embeds = None
        if pixel_values is not None:
            with timer.stage("vision_tower_images"):
                image_embeds = self.run_vision_images(pixel_values, igrid)

        video_embeds = None
        keypatch_tokens = np.zeros(len(ids), dtype=bool)
        if pixel_values_videos is not None:
            video_features = self.encode_video(pixel_values_videos, grid[0], on_dispatch,
                                               _timer=timer)
        vf = prefix.features if prefix is not None else video_features
        if vf is not None:
            if vf.tgt != vf.t:
                vi = np.where(ids == cfg.video_token_id)[0]
                ids, pos = pos_lib.reforge_after_visual_compression(
                    ids, pos, (int(vi[0]), int(vi[-1]) + 1), vf.tgt * vf.hw, vf.t - vf.tgt
                )
                keypatch_tokens = np.zeros(len(ids), dtype=bool)
            if prefix is None:  # the prefix's video KV is already in its cache
                video_embeds = vf.embeds
                vi = np.where(ids == cfg.video_token_id)[0]
                keypatch_tokens[vi[0] : vi[0] + len(vf.keymask)] = vf.keymask

        chunk_tokens = self.get_chunk_tokens(grid[0]) if grid is not None else None
        out = prefill_and_decode(
            self.model, cfg, self.retake,
            ids=ids, pos=pos, keypatch_tokens=keypatch_tokens,
            video_embeds=video_embeds, video_token_id=cfg.video_token_id,
            chunk_tokens=chunk_tokens, decode_pos_base=decode_pos_base,
            max_new_tokens=max_new_tokens, attn_impl=self.attn_impl,
            timer=timer, t_start=t0, device=self.device,
            prefill_only=_prefill_only, on_dispatch=on_dispatch,
            act_quant=self.act_quant and self.model.int8,
            image_embeds=image_embeds, image_token_id=cfg.image_token_id,
            sampler=self.sampler, capture_reserve=_capture_reserve, prefix=prefix,
        )
        if _capture_reserve is not None:
            out.features = video_features  # metadata and the fallback artifact
        return out

    def encode_prefix(
        self,
        input_ids: np.ndarray,
        pixel_values_videos=None,
        video_grid_thw=None,
        video_features: Optional[VideoFeatures] = None,
        max_new_tokens: Optional[int] = None,
        reserve_tokens: int = 512,
        on_dispatch=None,
    ) -> VideoPrefix:
        """Vision and the question-independent video prefill, once: a
        ``VideoPrefix`` after which ``generate(input_ids, prefix=...)`` runs
        only the trailing text segment and decode. ``input_ids`` is any full
        prompt with the video span (its suffix is not run);
        ``reserve_tokens`` bounds how much longer a later question's suffix
        may be."""
        return self.generate(
            input_ids, pixel_values_videos, video_grid_thw,
            max_new_tokens=max_new_tokens, video_features=video_features,
            _capture_reserve=int(reserve_tokens), on_dispatch=on_dispatch,
        )


def plan_chunks(
    ids: np.ndarray,
    video_token_id: int,
    chunk_tokens: Optional[int],
    ratio: float,
    compress_video: bool,
    prompt_guided: bool = False,
) -> tuple:
    """Host plan: (steps, final cache length, max write extent). Each step
    is a dict with kind, offset, valid, chunk_len, keep, cache_len and
    prompt_len. ``prompt_guided``: every video chunk also carries the last
    text segment (the question), ``prompt_len`` rows after its valid video
    rows, and keeps ``int(ratio * (valid + prompt_len))`` entries."""
    s = len(ids)
    if chunk_tokens is None:
        segments = [(0, s, "text")]
    else:
        segments = pos_lib.segment_modalities(ids, video_token_id)
    p_len = 0
    if prompt_guided:
        sp, ep, kind = segments[-1]
        if kind != "text":
            raise ValueError("prompt-guided compression needs a trailing text segment")
        p_len = ep - sp
    plan: List[dict] = []
    cache_len = 0
    max_extent = 0
    for seg_s, seg_e, kind in segments:
        n = seg_e - seg_s
        if kind == "text":
            padded = max(TEXT_BUCKET, math.ceil(n / TEXT_BUCKET) * TEXT_BUCKET)
            plan.append(dict(kind="text", offset=seg_s, valid=n, chunk_len=padded,
                             keep=n, cache_len=cache_len, prompt_len=0))
            max_extent = max(max_extent, cache_len + padded)
            cache_len += n
            continue
        for ci in range(math.ceil(n / chunk_tokens)):
            ss = seg_s + ci * chunk_tokens
            valid = min(chunk_tokens, seg_e - ss)
            q_len = valid + p_len
            keep = max(1, int(ratio * q_len)) if compress_video else q_len
            plan.append(dict(kind="video", offset=ss, valid=valid, chunk_len=chunk_tokens,
                             keep=keep, cache_len=cache_len, prompt_len=p_len))
            max_extent = max(max_extent, cache_len + chunk_tokens + p_len)
            cache_len += keep
    return plan, cache_len, max_extent


def _prompt_block(embeds, pos_dev, kp_dev, step, prompt_offset):
    """The prompt-guided chunk ``[video valid prefix | prompt | leftover]`` of
    ``chunk_len + prompt_len`` rows (reference forge_input_chunks,
    qwen2_vl.py:493-519): the prompt's positions are shifted to continue
    right after the chunk's last valid token, and its rows are not
    keypatches. Every offset is a host int, so this is slicing only."""
    off, valid, n, pl = step["offset"], step["valid"], step["chunk_len"], step["prompt_len"]
    video = torch.cat([embeds[off : off + n], embeds.new_zeros((pl, embeds.shape[1]))])
    hidden = torch.cat([video[:valid], embeds[prompt_offset : prompt_offset + pl],
                        video[valid + pl :]])
    pos_v = pos_dev[:, off : off + n]
    pos_v = torch.cat([pos_v, pos_v[:, -1:].expand(3, pl)], dim=1)
    pos_p = pos_dev[:, prompt_offset : prompt_offset + pl]
    shift = pos_p[0, 0] - pos_v[0, max(valid - 1, 0)] - 1
    pos3 = torch.cat([pos_v[:, :valid], pos_p - shift, pos_v[:, valid + pl :]], dim=1)
    kp_v = torch.cat([kp_dev[off : off + n], kp_dev.new_zeros(pl)])
    kp = torch.cat([kp_v[:valid], kp_dev.new_zeros(pl), kp_v[valid + pl :]])
    return hidden, pos3, kp


def _spec_decode_loop(
    model: Qwen2VLModel,
    cfg: Qwen2VLConfig,
    kv: cache_lib.KVCache,
    first_token: int,
    pos_base: int,
    prompt_tail: np.ndarray,  # [POOL_PROMPT] int, left-padded with -1
    max_new: int,
    ngram: int,
    draft: int,
    reforge: bool,
    attn_impl: str,
) -> tuple:
    """Prompt-lookup speculative decode, greedy (reference
    ``_spec_decode_loop``, engine.py:347-445), as a host loop over device
    verify steps. Each step matches the trailing ``ngram`` tokens of
    [prompt tail | generated] against earlier occurrences, proposes the
    ``draft`` tokens that followed the latest match (junk where none did;
    verification rejects it), and verifies all of them in one chunk of
    ``draft + 1`` rows. Rejected proposals roll back by the cache length
    only: their K/V lie past it and the next chunk overwrites them.
    Returns (tokens [max_new + draft], EOS past the stream; m tokens
    emitted; n_it verify steps)."""
    eos = cfg.eos_token_id
    dev = kv.k.device
    k1 = draft + 1
    p0 = len(prompt_tail)
    pool_len = p0 + 1 + max_new + k1
    pool = np.full(pool_len, -1, np.int64)
    pool[:p0] = prompt_tail
    pool[p0] = first_token
    buf = np.full(max_new + k1, eos, np.int64)
    win_starts = np.arange(pool_len - ngram)
    win_idx = win_starts[:, None] + np.arange(ngram)
    idx_k1 = np.arange(k1)
    k1_dev = torch.tensor(k1, dtype=torch.int32, device=dev)
    no_keypatch = torch.zeros(k1, dtype=torch.bool, device=dev)
    m = n_it = 0
    cur, done = first_token, first_token == eos
    while m < max_new and not done:
        cur_len = p0 + 1 + m
        suffix = pool[cur_len - ngram : cur_len]
        ok = (pool[win_idx] == suffix).all(axis=-1) & (win_starts < cur_len - ngram)
        last = int(win_starts[ok].max()) if ok.any() else -1
        start = min(max(last, 0) + ngram, pool_len - draft)  # dynamic_slice clamps
        prop = pool[start : start + draft]
        chunk = torch.from_numpy(np.concatenate([[cur], prop])).to(dev)
        pos3 = torch.from_numpy(
            np.broadcast_to(pos_base + m + idx_k1, (3, k1)).astype(np.int32)).to(dev)
        hidden, kv = text.decoder_chunk(
            model, cfg, kv, text.embed(model, chunk), pos3, k1_dev, no_keypatch, k1_dev,
            compress=False, reforge=reforge, attn_impl=attn_impl,
        )
        nxt = torch.argmax(text.final_logits_batch(model, cfg, hidden), dim=-1).cpu().numpy()
        a_acc = int(np.cumprod(prop == nxt[:draft]).sum())
        is_eos = (nxt == eos) & (idx_k1 <= a_acc)
        done = bool(is_eos.any())
        emit_n = int(np.argmax(is_eos)) + 1 if done else a_acc + 1
        emit = np.where(idx_k1 < emit_n, nxt, eos)
        buf[m : m + k1] = emit
        pool[cur_len : cur_len + k1] = emit
        kv.length -= k1 - emit_n  # keep K/V for the emit_n verified inputs only
        cur = int(nxt[emit_n - 1])
        m += emit_n
        n_it += 1
    return buf, m, n_it


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
    image_embeds: Optional[torch.Tensor] = None,  # [n image tokens, d], token order
    image_token_id: Optional[int] = None,
    sampler: Optional[Sampler] = None,  # None: greedy
    capture_reserve: Optional[int] = None,  # capture a VideoPrefix, reserving
    #   this many suffix tokens in the budget
    prefix: Optional[VideoPrefix] = None,  # resume from a captured prefix
):
    """Chunked prefill over one static cache budget, then decode (greedy,
    sampled or speculative); with ``prefill_only`` the ``PrefillState`` for
    batched decode, with ``capture_reserve`` the ``VideoPrefix`` after the
    last video chunk. With ``prefix`` the plan's prefix steps are skipped:
    their K/V come from a fork of the captured cache. An int8 KV cache
    (``kv_cache_dtype: int8``) takes each decode token quantized per key."""
    s = len(ids)
    ratio = rt.compression_ratio_for(s)
    reforge = rt.kv.pos_embed_reforge and rt.kvcache_compression
    compress_video = rt.kvcache_compression and ratio < 1.0
    prompt_guided = rt.kv.prompt_guided_compression and compress_video

    plan, final_len, max_extent = plan_chunks(
        ids, video_token_id, chunk_tokens, ratio, compress_video, prompt_guided
    )
    # spec decode writes (then rolls back) up to spec_draft K/V entries past
    # the accepted stream
    spec = bool(rt.spec_decode) and sampler is None
    spec_draft = int(rt.spec_draft) if spec else 0
    needed = max(max_extent, final_len + max_new_tokens + spec_draft)
    budget = math.ceil(needed / BUDGET_BUCKET) * BUDGET_BUCKET

    # cross-question reuse: the plan through the last video chunk is
    # question-independent unless the question rides in the video chunks
    n_prefix_steps = 0
    if capture_reserve is not None or prefix is not None:
        if prompt_guided:
            raise PrefixUnsupported(
                "prefix reuse requires prompt_guided_compression off (the question "
                "enters every video chunk)"
            )
        vid_steps = [i for i, p in enumerate(plan) if p["kind"] == "video"]
        if not vid_steps:
            raise ValueError("no video segment: nothing to capture or reuse")
        last_vid = vid_steps[-1]
        split = plan[last_vid]["offset"] + plan[last_vid]["valid"]
        n_prefix_steps = last_vid + 1
        if n_prefix_steps == len(plan):
            raise ValueError("prompt ends with the video span; prefix reuse needs a "
                             "trailing text (question) segment for the first token")
        plan_sig = tuple((p["kind"], p["offset"], p["valid"], p["keep"] if p["kind"] == "video"
                          else -1) for p in plan[:n_prefix_steps])
        prefix_len = plan[last_vid]["cache_len"] + plan[last_vid]["keep"]
    if prefix is not None:
        if split != prefix.split or not np.array_equal(ids[:split], prefix.prefix_ids):
            raise PrefixMismatch("prompt prefix differs from the captured prefix (same "
                                 "video, system prompt and frame count required)")
        if plan_sig != prefix.plan_sig:
            raise PrefixMismatch("prefill plan diverged from the captured prefix "
                                 f"(dynamic compression ratio? input_len={s})")
        if prefix_len != prefix.final_len:
            raise PrefixMismatch(f"prefix length {prefix_len} != captured {prefix.final_len}")
        if needed > prefix.budget:
            raise PrefixBudgetOverflow(
                f"cache budget {prefix.budget} too small for this question (needs "
                f"{needed}); re-encode the prefix with a larger reserve_tokens"
            )
        budget = prefix.budget
        if video_embeds is not None:
            raise ValueError("generate(prefix=...) takes no video embeddings")
        if image_embeds is not None and np.any(np.flatnonzero(ids == image_token_id) < split):
            raise NotImplementedError("image tokens inside the captured prefix span")
    elif capture_reserve is not None:
        needed = max(max_extent, prefix_len + capture_reserve + max_new_tokens + spec_draft)
        budget = math.ceil(needed / BUDGET_BUCKET) * BUDGET_BUCKET

    # device inputs: ids/positions/keypatch padded to the plan's extent, and
    # every step's (valid_len, keep_len) in one table (a prompt-guided
    # chunk's valid rows include the prompt)
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
        [[p["valid"] + p["prompt_len"], p["keep"]] for p in plan] + [[1, 1]], dtype=torch.int32
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
    if image_embeds is not None:
        # each contiguous image-token span takes the next rows of the
        # concatenated image embeddings (masked_scatter order)
        img_idx = np.flatnonzero(ids == image_token_id)
        if len(img_idx) != image_embeds.shape[0]:
            raise ValueError(f"image tokens {len(img_idx)} != image features "
                             f"{image_embeds.shape[0]}")
        breaks = np.flatnonzero(np.diff(img_idx) > 1)
        starts = np.concatenate([img_idx[:1], img_idx[breaks + 1]])
        ends = np.concatenate([img_idx[breaks] + 1, img_idx[-1:] + 1])
        off = 0
        for s0, e0 in zip(starts.tolist(), ends.tolist()):
            embeds[s0:e0] = image_embeds[off : off + e0 - s0].to(embeds.dtype)
            off += e0 - s0
    video_embeds = image_embeds = None

    if prefix is not None:  # the snapshot serves the video's other questions
        kv = _fork_cache(prefix.cache)
    else:
        kv = cache_lib.init_cache(
            cfg.num_hidden_layers, cfg.num_key_value_heads, budget, cfg.head_dim,
            dtype=embeds.dtype, device=device, quantized=rt.kv_cache_dtype == "int8",
        )

    # resume: the prefix steps live in the forked cache; capture: stop after
    # the last video chunk (the suffix runs per question)
    first = n_prefix_steps if prefix is not None else 0
    n_run = n_prefix_steps if capture_reserve is not None else len(plan)
    prompt_offset = plan[-1]["offset"]
    hidden = None
    with timer.stage("prefill_chunks"):
        for i in range(first, n_run):
            step = plan[i]
            off, n = step["offset"], step["chunk_len"]
            if step["prompt_len"]:
                x, p3, kp = _prompt_block(embeds, pos_dev, kp_dev, step, prompt_offset)
            else:
                x, p3, kp = embeds[off : off + n], pos_dev[:, off : off + n], kp_dev[off : off + n]
            hidden, kv = text.decoder_chunk(
                model, cfg, kv, x, p3, lens_dev[i, 0], kp, lens_dev[i, 1],
                compress=step["kind"] == "video" and compress_video,
                reforge=reforge, attn_impl=attn_impl, act_quant=act_quant,
            )
            if on_dispatch is not None:
                on_dispatch()

    if capture_reserve is not None:
        fill = int(kv.length)  # waits for the prefix steps
        if fill != prefix_len:
            raise RuntimeError(f"prefix cache fill {fill} != planned {prefix_len}")
        timer.report()
        return VideoPrefix(
            cache=kv, final_len=prefix_len, budget=budget, split=split,
            prefix_ids=np.asarray(ids[:split]).copy(), plan_sig=plan_sig,
            prefill_seconds=time.perf_counter() - t_start,
            stages=dict(timer.totals) if timer.totals else None,
        )
    last_valid = plan[-1]["valid"] + plan[-1]["prompt_len"]

    with timer.stage("first_token"):
        logits = text.final_logits(model, cfg, hidden[last_valid - 1])
        token = select_tokens(logits[None], sampler, FIRST, [0])
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

    # decode; with early stop the host checks each token one step late, so
    # it never waits on the step it is enqueuing
    t0 = time.perf_counter()
    out_tokens = [token_host]
    eos = cfg.eos_token_id
    spec_steps = None
    if max_new_tokens > 1 and token_host != eos:
        with timer.stage("decode"):
            if spec:
                tail = np.full(POOL_PROMPT, -1, np.int64)
                t = ids[-POOL_PROMPT:]
                tail[POOL_PROMPT - len(t) :] = t
                tokens, n_emit, n_steps = _spec_decode_loop(
                    model, cfg, kv, token_host, decode_pos_base, tail, max_new_tokens - 1,
                    int(rt.spec_ngram), spec_draft, reforge, attn_impl,
                )
                tokens = tokens[: max_new_tokens - 1]
                spec_steps = (n_emit, n_steps)
                timer.totals["spec_tokens_per_step"] = round(n_emit / max(n_steps, 1), 3)
            else:
                early_stop = bool(rt.decode_early_stop)
                one = lens_dev[-1, 0]
                no_keypatch = torch.zeros(1, dtype=torch.bool, device=device)
                pos_base = torch.full((3, 1), decode_pos_base, dtype=torch.int32, device=device)
                steps = []
                for i in range(max_new_tokens - 1):
                    hidden, kv = text.decoder_chunk(
                        model, cfg, kv, text.embed(model, token), pos_base + i,
                        one, no_keypatch, one, compress=False, reforge=reforge,
                        attn_impl=attn_impl,
                    )
                    token = select_tokens(text.final_logits(model, cfg, hidden[0])[None],
                                          sampler, LOOP, [i])
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
        spec_steps=spec_steps,
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
    sampler: Optional[Sampler] = None,  # None: greedy
    dec_start=None,  # [B] int32 per-slot decode-region start; None = gap_start
    i0: int = 0,  # global decode steps taken before this call (write pointer)
    done0=None,  # [B] bool slots already finished or free; None = first == eos
    attn_impl: str = "xla",  # "pallas": K4; "xla": full-bucket masked softmax
    early_stop: bool = False,  # stop once every slot is done (checked one step late)
    max_steps=None,  # [B] int32 per-slot output budget (max_new_tokens - 1)
    ks_all=None,  # [L, B, KV, S] f32 scale planes of an int8 cache, written in place
    vs_all=None,
    step_off=None,  # [B] host ints: slot b draws at its own step i - step_off[b]
) -> torch.Tensor:
    """Batched decode: ``num_steps`` steps for all B slots; returns
    the tokens [num_steps, B] (int64, on the device). Step i's K/V land at
    the shared column ``gap_start + i`` (quantized per key into an int8
    cache, their scales into the scale planes). A slot that is done emits
    EOS. With ``early_stop`` the host reads ``all(done)`` of the previous
    step while the current one is queued, so at most one step more than
    needed runs; the skipped rows stay EOS, as in the JAX while-loop. A
    sampled step draws each slot at its request-own step (the global step
    ``i0 + j`` minus ``step_off``), the sequential loop's schedule."""
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
        own = [i - int(o) for o in step_off] if step_off is not None else [i] * len(tokens)
        nxt = select_tokens(text.final_logits_batch(model, cfg, hidden), sampler, LOOP, own)
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
    sampler: Optional[Sampler] = None,  # None: the config's (greedy without do_sample)
) -> List[GenerationResult]:
    """Batched decode over prefilled requests (``generate_batch``).
    Requests whose first token is EOS do not join the batch; the others
    share the decode region starting at their largest ``final_len``."""
    if not states:
        return []
    if any(st.reforge != states[0].reforge for st in states):
        raise ValueError("decode_batch: mixed reforge settings across prefill states")
    sampler = sampler or Sampler.from_config(rt)
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
            max_new_tokens - 1, sampler=sampler, attn_impl=attn_impl, early_stop=early_stop,
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
