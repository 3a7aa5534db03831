"""LLaVA-OneVision / LLaVA-Video inference engine (port of
``retake_tpu/runtime/llava_engine.py``).

The SigLIP tower in frame chunks -> DPSelect on the *pre-projector*
features -> the projector and 2x2 bilinear pooling in 64-frame chunks into
one buffer -> ``image_newline`` -> the Qwen engine's chunked prefill,
PivotKV and decode (``engine.prefill_and_decode`` / ``decode_batch``) with
1-D RoPE. Under "pallas" the prefill runs K1 and K2 in every layer and
``generate_batch`` decodes through K4; SigLIP attention is plain torch, as
in the JAX package.

The reference's keypatch quirk is kept: the DPSelect keypatch mask is
computed on the un-pooled 27x27 patch grid ([tgt * 729] flags) but laid
onto the pooled token stream (tgt * 196 + 1 tokens) by truncation, as its
``masked_scatter`` does (reference llava_onevision.py:485-486).

Tensor parallelism (``tp=``, the JAX engine's ``cache_sharding=``): the
decoder runs sharded through the Qwen engine's core, and SigLIP shards the
frames of every chunk whose frame count divides ``tp`` (the JAX
``_siglip_chunk_tp``), the features all-gathered in frame order.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from retake_tpu_torch import device as device_lib
from retake_tpu_torch.models.llava_onevision import anyres, siglip
from retake_tpu_torch.models.llava_onevision.config import LlavaOnevisionConfig
from retake_tpu_torch.models.llava_onevision.model import LlavaOnevisionModel
from retake_tpu_torch.ops import dpselect
from retake_tpu_torch.runtime.engine import (
    PrefixMismatch,
    VideoFeatures,
    batched_decode_impl,
    bind_tp,
    check_replicas,
    decode_batch,
    prefill_and_decode,
)
from retake_tpu_torch.runtime.sampling import Sampler
from retake_tpu_torch.utils.config import RetakeConfig
from retake_tpu_torch.utils.profiling import StageTimer, span, spanned

PROJECT_CHUNK = 64  # frames projected and pooled at a time


class LlavaOnevisionEngine:
    """Single-request long-video engine for the LLaVA-OneVision family.
    ``model_or_params``: a ``LlavaOnevisionModel`` or its parameter tree
    (under ``tp``, the rank's ``shard_params`` slice). ``tp`` and
    ``noise_fn`` as in ``Qwen2VLEngine``."""

    def __init__(self, cfg: LlavaOnevisionConfig, model_or_params, retake: RetakeConfig,
                 device="cuda", tp=None):
        self.device = device_lib.resolve(device)
        model = model_or_params
        if not isinstance(model, LlavaOnevisionModel):
            model = LlavaOnevisionModel(cfg, model_or_params, tp)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, engine on {self.device}")
        self.tp = bind_tp(model, tp, self.device)
        if retake.scaling_factor:
            cfg = cfg.with_yarn(retake.scaling_factor)
        self.cfg = cfg
        self.model = model
        self.retake = retake
        impl = retake.attn_implementation
        self.attn_impl = impl if impl in ("flash", "pallas", "xla") else "pallas"
        self.act_quant = retake.quantization == "w8a8"
        self.noise_fn = None

    @property
    def sampler(self) -> Optional[Sampler]:
        return Sampler.from_config(self.retake, self.noise_fn)

    def _vision_aq(self) -> bool:
        """SigLIP W8A8 only where its weights are int8."""
        return self.act_quant and self.model.vision_int8

    def _tower(self, frames_u8: torch.Tensor) -> torch.Tensor:
        vt = self.model.vision_tower
        patches = siglip.patchify_frames(frames_u8, self.cfg.vision, vt.patch_embed.w.dtype)
        return siglip.siglip_tower(vt, self.cfg.vision, patches, self._vision_aq())

    def _tower_chunk(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """SigLIP over one chunk of frames (on the host or the device).
        Under TP, when the frame count divides over the ranks, each runs its
        share and the features are all-gathered in frame order."""
        tp, t = self.tp, frames_u8.shape[0]
        if tp is None or t % tp.size:
            return self._tower(frames_u8.to(self.device))
        per = t // tp.size
        mine = frames_u8[tp.rank * per : (tp.rank + 1) * per].to(self.device)
        return tp.all_gather(self._tower(mine))

    def run_vision(self, frames, on_dispatch=None) -> torch.Tensor:
        """frames [T, 384, 384, 3] uint8 -> SigLIP features [T, 729, 1152]
        in chunks of ``frame_chunk_size`` frames (reference
        llava_onevision.py:424-439). ``on_dispatch``: the serving hook,
        called after each chunk is enqueued."""
        frames = torch.as_tensor(frames)
        t, s = frames.shape[0], self.cfg.vision.image_size
        if tuple(frames.shape[1:3]) != (s, s):
            raise ValueError(f"frames must be resized to {s}x{s} (got {tuple(frames.shape[1:3])}; "
                             "use data.processor.LlavaOnevisionVideoProcessor)")
        fcs = self.retake.frame_chunk_size or t
        out = None
        for i in range(0, t, fcs):
            with span("vision.chunk", chunk=i // fcs, frames=min(fcs, t - i)):
                feats = self._tower_chunk(frames[i : i + fcs])
                if out is None:
                    out = torch.empty((t,) + feats.shape[1:], dtype=feats.dtype,
                                      device=self.device)
                out[i : i + feats.shape[0]] = feats
            if on_dispatch is not None:
                on_dispatch()
        return out

    def get_chunk_tokens(self, num_frames: int) -> Optional[int]:
        """Reference get_chunk_size (llava_onevision.py:144-161):
        min(chunk_frames, T) * ceil(27/2)^2 tokens."""
        cf = self.retake.chunked_prefill_frames
        if cf is None:
            return None
        return min(cf, num_frames) * self.cfg.tokens_per_frame

    def run_vision_images(self, pixel_values, image_sizes) -> torch.Tensor:
        """Anyres still images (reference llava_onevision.py:383-416).
        pixel_values: [n, max_tiles, S, S, 3] uint8 (base tile first, then
        the grid tiles row-major); image_sizes: [n, 2] (H, W). Returns the
        concatenated packed token streams [sum(n_tok_i), d]; images are not
        pooled (HF parity)."""
        cfg = self.cfg
        sizes = np.asarray(image_sizes).reshape(-1, 2)
        pixels = torch.as_tensor(pixel_values)
        projector = self.model.projector.as_dict()
        outs = []
        for i, (oh, ow) in enumerate(sizes.tolist()):
            n_tiles = anyres.image_size_to_num_patches(
                (oh, ow), cfg.image_grid_pinpoints, cfg.vision.image_size)
            feats = self._tower(pixels[i, :n_tiles].to(self.device))
            proj = siglip.multi_modal_projector(projector, feats, self._vision_aq())
            outs.append(anyres.pack_image_feature(
                proj, (oh, ow), grid_side=cfg.grid_side, pinpoints=cfg.image_grid_pinpoints,
                tile_size=cfg.vision.image_size, image_newline=self.model.image_newline,
                vision_aspect_ratio=cfg.vision_aspect_ratio,
            ))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _project_pool_newline(self, features: torch.Tensor) -> torch.Tensor:
        """[t, 729, 1152] -> the video's LLM embeddings [t*196 + 1, d]: the
        projector and the pooling run in 64-frame chunks (the un-pooled
        projector output is [t, 729, d], 5.4 GB at 1024 frames and 7B
        width) into one buffer, ``image_newline`` last."""
        cfg = self.cfg
        t, n = features.shape[0], cfg.tokens_per_frame
        projector = self.model.projector.as_dict()
        out = None
        for i in range(0, t, PROJECT_CHUNK):
            x = siglip.multi_modal_projector(projector, features[i : i + PROJECT_CHUNK],
                                             self._vision_aq())
            x = siglip.apply_pooling(x, cfg.grid_side, cfg.pooled_grid)
            if out is None:
                out = torch.empty((t * n + 1, x.shape[-1]), dtype=x.dtype, device=x.device)
                out[t * n] = self.model.image_newline.to(x.dtype)
            out[i * n : (i + x.shape[0]) * n] = x.reshape(-1, x.shape[-1])
        return out

    def encode_video(self, pixel_values_videos, video_grid_thw=None, on_dispatch=None,
                     _timer=None) -> VideoFeatures:
        """SigLIP tower, visual compression, projector / pooling / newline:
        the question-independent artifact ``generate(video_features=...)``
        takes (``video_grid_thw`` is unused: the Qwen engine's signature)."""
        timer = _timer or StageTimer(device=self.device)
        cfg, rt = self.cfg, self.retake
        t = int(pixel_values_videos.shape[0])
        with timer.stage("vision", "vision_tower", frames=t):
            features = self.run_vision(pixel_values_videos, on_dispatch=on_dispatch)
        hw = cfg.vision.num_patches
        tgt = t
        keymask_np = np.zeros(0, bool)
        if rt.visual_compression:
            with timer.stage("dpselect"):
                vc = rt.visual
                tgt = max(1, round(vc.compression_ratio * t))
                if vc.compression_method == "Keyframe":
                    keep, keymask = dpselect.dpselect(features, tgt, 3, vc.patch_sync)
                    if tgt != t:  # ratio 1.0 keeps every frame: mask only
                        features = dpselect.gather_keyframes(features, keep)
                    if vc.patch_sync:
                        keymask = keymask[:, None].expand(tgt, hw)
                    keymask_np = (keymask.reshape(-1).cpu().numpy() if vc.return_keyframe_mask
                                  else np.zeros(tgt * hw, bool))
                elif vc.compression_method in ("MA-LLM", "MA-LLM-hard"):
                    features = dpselect.malm_compress(
                        features, tgt, sync=vc.patch_sync,
                        hard=vc.compression_method == "MA-LLM-hard")
                    keymask_np = np.zeros(tgt * hw, bool)
                else:
                    raise NotImplementedError(vc.compression_method)
        with timer.stage("projector_pool"):
            embeds = self._project_pool_newline(features)
        return VideoFeatures(embeds=embeds, keymask=keymask_np, t=t, tgt=tgt, hw=hw, grid=None)

    @spanned("request")
    def generate(
        self,
        input_ids: np.ndarray,
        pixel_values_videos=None,  # [T, 384, 384, 3] uint8
        video_grid_thw=None,  # unused (the Qwen engine's signature)
        max_new_tokens: Optional[int] = None,
        pixel_values=None,  # [n, tiles, S, S, 3] uint8
        image_sizes=None,  # [n, 2] (H, W)
        video_features: Optional[VideoFeatures] = None,  # an encode_video artifact
        prefix=None,  # an encode_prefix artifact (engine.VideoPrefix)
        _prefill_only: bool = False,
        _capture_reserve: Optional[int] = None,  # encode_prefix plumbing
        on_dispatch=None,  # serving hook, see Qwen2VLEngine.generate
    ):
        """One request: ``GenerationResult``, or with ``_prefill_only`` the
        ``PrefillState``, with ``_capture_reserve`` the ``VideoPrefix``."""
        timer = StageTimer(device=self.device)
        cfg, rt = self.cfg, self.retake
        max_new_tokens = max_new_tokens or rt.max_new_tokens
        ids = np.asarray(input_ids, dtype=np.int64).reshape(-1)
        t_start = time.perf_counter()

        image_embeds = None
        if pixel_values is not None:
            with timer.stage("vision", "vision_tower_images", images=np.size(image_sizes) // 2):
                image_embeds = self.run_vision_images(pixel_values, image_sizes)

        video_embeds = None
        keypatch_tokens = np.zeros(len(ids), dtype=bool)
        num_frames = 0
        if prefix is not None:
            if pixel_values_videos is not None or video_features is not None:
                raise ValueError("generate(prefix=...) replaces both the pixels and the "
                                 "video_features inputs")
            # the placeholder span is truncated as the inline path did at the
            # capture; the video's K/V is already in the prefix cache
            t, tgt = prefix.features.t, prefix.features.tgt
            n_vid = int(np.sum(ids == cfg.video_token_id))
            n_expected = t * cfg.tokens_per_frame + 1
            if n_vid != n_expected:
                raise PrefixMismatch(f"prompt has {n_vid} video tokens but the captured prefix "
                                     f"has {n_expected}")
            num_frames = t
            if tgt != t:
                vi = np.where(ids == cfg.video_token_id)[0]
                keep_end = int(vi[0]) + tgt * cfg.tokens_per_frame + 1
                ids = np.concatenate([ids[:keep_end], ids[int(vi[-1]) + 1 :]])
                keypatch_tokens = np.zeros(len(ids), dtype=bool)
        if pixel_values_videos is not None:
            video_features = self.encode_video(pixel_values_videos, on_dispatch=on_dispatch,
                                               _timer=timer)
        if video_features is not None:
            vf = video_features
            video_embeds = vf.embeds
            t, tgt = vf.t, vf.tgt
            num_frames = t
            n_video_tokens = tgt * cfg.tokens_per_frame + 1
            if tgt != t:  # drop the placeholders of dropped frames (reference :252-265)
                vi = np.where(ids == cfg.video_token_id)[0]
                keep_end = int(vi[0]) + n_video_tokens
                ids = np.concatenate([ids[:keep_end], ids[int(vi[-1]) + 1 :]])
                keypatch_tokens = np.zeros(len(ids), dtype=bool)
            vi = np.where(ids == cfg.video_token_id)[0]
            if len(vf.keymask):  # the quirk: the [tgt*729] mask truncated to the pooled count
                kp = vf.keymask[:n_video_tokens]
                keypatch_tokens[vi[0] : vi[0] + len(kp)] = kp

        s = len(ids)
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, s)).copy()
        chunk_tokens = self.get_chunk_tokens(num_frames) if num_frames else None
        out = prefill_and_decode(
            self.model, cfg.text, rt,
            ids=ids, pos=pos, keypatch_tokens=keypatch_tokens,
            video_embeds=video_embeds, video_token_id=cfg.video_token_id,
            chunk_tokens=chunk_tokens, decode_pos_base=s,
            max_new_tokens=max_new_tokens, attn_impl=self.attn_impl,
            timer=timer, t_start=t_start, device=self.device,
            prefill_only=_prefill_only, on_dispatch=on_dispatch,
            act_quant=self.act_quant and self.model.int8,
            image_embeds=image_embeds, image_token_id=cfg.image_token_id,
            sampler=self.sampler, capture_reserve=_capture_reserve, prefix=prefix,
        )
        if _capture_reserve is not None:
            out.features = video_features  # metadata and the fallback artifact
        check_replicas(self.tp, "generate", out,
                       prefix.features if prefix is not None else video_features)
        return out

    def encode_prefix(self, input_ids, pixel_values_videos=None, video_grid_thw=None,
                      video_features: Optional[VideoFeatures] = None,
                      max_new_tokens: Optional[int] = None, reserve_tokens: int = 512,
                      on_dispatch=None):
        """The question-independent video prefill as an ``engine.VideoPrefix``
        (see ``Qwen2VLEngine.encode_prefix``)."""
        return self.generate(
            input_ids, pixel_values_videos, max_new_tokens=max_new_tokens,
            video_features=video_features, _capture_reserve=int(reserve_tokens),
            on_dispatch=on_dispatch,
        )

    def generate_batch(self, requests: list, max_new_tokens: Optional[int] = None) -> list:
        """Sequential prefill, one batched decode (``engine.decode_batch``;
        K4 on CUDA, as ``Qwen2VLEngine.generate_batch``); each request may
        carry its own ``max_new_tokens``."""
        if not requests:
            return []
        default_max = max_new_tokens or self.retake.max_new_tokens
        req_max = [int(req.get("max_new_tokens") or default_max) for req in requests]
        batch_max = max(req_max)
        states = [
            self.generate(**{k: v for k, v in req.items() if k != "max_new_tokens"},
                          max_new_tokens=batch_max, _prefill_only=True)
            for req in requests
        ]
        results = decode_batch(
            self.model, self.cfg.text, self.retake, states, batch_max,
            attn_impl=batched_decode_impl(self.cfg.text, self.device),
            early_stop=bool(self.retake.decode_early_stop), req_max=req_max,
            sampler=self.sampler,
        )
        for res, m in zip(results, req_max):
            res.tokens = res.tokens[:m]
        if self.tp is not None:
            self.tp.assert_replicated("generate_batch", *[r.tokens for r in results])
        return results


def load_llava_engine(hf_path: str, rt: RetakeConfig, device="cuda") -> LlavaOnevisionEngine:
    """An engine over a checkpoint directory: a pre-quantized tree
    (``utils/checkpoint.py``) or HF safetensors, quantized as
    ``rt.quantization`` asks (W8A8 also quantizes SigLIP and the
    projector)."""
    from retake_tpu_torch.models.llava_onevision import params as params_lib
    from retake_tpu_torch.ops import quantization as q8
    from retake_tpu_torch.utils import checkpoint

    cfg = LlavaOnevisionConfig.from_pretrained(hf_path)
    if checkpoint.has_params(hf_path):
        params = checkpoint.load_checked(hf_path, rt, "llava_onevision", device=device)
        return LlavaOnevisionEngine(cfg, params, rt, device=device)
    params = params_lib.load_safetensors(hf_path, cfg, device=device)
    if rt.quantization in ("int8", "w8a8"):
        params = q8.quantize_llm_int8(params)
    if rt.quantization == "w8a8":
        params = q8.quantize_siglip_int8(params)
    return LlavaOnevisionEngine(cfg, params, rt, device=device)
