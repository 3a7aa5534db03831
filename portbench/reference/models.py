"""The reference for a whole request of each model family: vision, the
DPSelect keypatches, the ReTaKe prefill and the served tokens, all in
float32 from the harness's own parameter tree and inputs."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import text as text_ref
from portbench.reference import vision as vision_ref


def _keypatches(retake: dict, bank: torch.Tensor) -> np.ndarray:
    """DPSelect's keypatch flags [T * N] for a [T, N, C] bank (Keyframe at
    compression ratio 1: every frame kept, the peaks flagged)."""
    lv = retake.get("longvideo_kwargs", {})
    n = bank.shape[0] * bank.shape[1]
    if not lv.get("visual_compression"):
        return np.zeros(n, bool)
    vc = lv.get("visual_compression_kwargs", {})
    if vc.get("compression_method", "Keyframe") != "Keyframe" or vc.get(
            "compression_ratio", 1.0) != 1.0 or vc.get("patch_sync"):
        raise NotImplementedError("the reference covers per-patch Keyframe DPSelect at ratio 1")
    if not vc.get("return_keyframe_mask", True):
        return np.zeros(n, bool)
    return text_ref.keyframe_peaks(bank).reshape(-1).cpu().numpy()


def _chunk_frames(retake: dict):
    return retake.get("longvideo_kwargs", {}).get("chunked_prefill_frames")


def qwen2_vl_logits(tree: dict, config: dict, ids: np.ndarray, patches: torch.Tensor, grid,
                    streams: list, device) -> list:
    """Qwen2-VL: for each stream of served tokens, the reference's logits
    at their positions."""
    retake, v = config["retake"], config["vision_config"]
    m = v["spatial_merge_size"]
    t, h, w = (int(x) for x in grid)
    video = vision_ref.qwen_vit(tree["visual"], v, patches, grid, device)
    keypatch = _keypatches(retake, video.reshape(t, h * w // m**2, -1))
    vid_id = config["video_token_id"]
    pos = text_ref.mrope_positions(ids, vid_id, grid, m)
    cf = _chunk_frames(retake)
    chunk = None if cf is None else min(cf, t * v["temporal_patch_size"]) * h * w // (
        m * m * v["temporal_patch_size"])
    text = text_ref.TextReference(tree, config, retake,
                                  config["rope_scaling"]["mrope_section"], device)
    chunks = text_ref.prompt_chunks(text, ids, pos, video, keypatch, vid_id, chunk, retake)
    del video
    return text_ref.served_logits(text, chunks, int(pos.max()) + 1, streams)


def llava_video_logits(tree: dict, config: dict, ids: np.ndarray, frames: torch.Tensor,
                       streams: list, device) -> list:
    """LLaVA-Video: the same, through SigLIP, the projector and the pooling,
    with 1-D RoPE. The keypatch flags are those of the un-pooled patch grid
    laid onto the pooled token stream from its start, as the published
    implementation lays them."""
    retake, v, tc = config["retake"], config["vision_config"], config["text_config"]
    feats = vision_ref.siglip(tree["vision_tower"], v, frames, device)
    keypatch = _keypatches(retake, feats)
    g = v["image_size"] // v["patch_size"]
    stride = config.get("pool_stride", 2)
    video = vision_ref.llava_video_embeds(tree, feats, g, stride, device)
    del feats
    t = frames.shape[0]
    per_frame = (-(-g // stride)) ** 2
    keypatch = keypatch[: video.shape[0]]
    vid_id = config["video_token_index"]
    s = len(ids)
    pos = np.broadcast_to(np.arange(s), (3, s)).astype(np.int64)
    cf = _chunk_frames(retake)
    chunk = None if cf is None else min(cf, t) * per_frame
    c = dict(tc, video_token_id=vid_id)
    text = text_ref.TextReference(tree, c, retake, None, device)
    chunks = text_ref.prompt_chunks(text, ids, pos, video, keypatch, vid_id, chunk, retake)
    del video
    return text_ref.served_logits(text, chunks, s, streams)
