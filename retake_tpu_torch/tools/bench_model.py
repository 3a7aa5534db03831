"""The bench model and request, without JAX: Qwen2-VL-2B with random weights
and a synthetic video prompt at 448x252 frames (port of ``bench.py``'s
``build_model`` / ``build_request`` / ``RETAKE_CONFIG``).

The request is 16 random text ids, the video span (``frames / 2 x 32 x 18``
patches merged 2x2: 144 tokens a frame pair) and a 48-id "question". Its ids
are ``bench.build_request``'s for the same seed; the patches are drawn on
the device from a ``torch.Generator`` (pixel-like values; not the JAX draws).
"""

from __future__ import annotations

import numpy as np
import torch

NUM_FRAMES = 2048
GRID_H, GRID_W = 32, 18  # 448x252 / 14
# the demo config's ReTaKe settings (bench.py RETAKE_CONFIG): DPSelect
# keyframe mask, 32-frame chunked prefill, PivotKV to 32000 tokens with
# position reforge, YaRN x4; attention: the kernels ("pallas", the default)
RETAKE_CONFIG = {
    "scaling_factor": 4,
    "longvideo_kwargs": {
        "frame_chunk_size": 128,
        "chunked_prefill_frames": 32,
        "visual_compression": True,
        "visual_compression_kwargs": {
            "compression_ratio": 1.0,
            "compression_method": "Keyframe",
            "patch_sync": False,
            "return_keyframe_mask": True,
        },
        "kvcache_compression": True,
        "kvcache_compression_kwargs": {
            "dynamic_compression_ratio": True,
            "compression_method": "pivotkv",
            "pos_embed_reforge": True,
            "max_input_length": 32000,
        },
    },
}


def build_model(device, seed: int = 0, dtype: torch.dtype = torch.bfloat16):
    """(cfg, params): the Qwen2-VL-2B geometry with random weights drawn on
    ``device`` from ``seed``."""
    from retake_tpu_torch.models.qwen2_vl import params as params_lib
    from retake_tpu_torch.models.qwen2_vl.config import qwen2_vl_2b

    cfg = qwen2_vl_2b()
    return cfg, params_lib.init_params(cfg, seed=seed, dtype=dtype, device=device)


def random_patches(cfg, n: int, device, seed: int) -> torch.Tensor:
    """``n`` bf16 patch rows of pixel-like values, drawn on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    raw = torch.randint(0, 255, (n, cfg.vision.patch_input_dim), generator=gen, device=device,
                        dtype=torch.int32)
    return ((raw.to(torch.float32) - 127.5) / 64.0).to(torch.bfloat16)


def build_request(cfg, num_frames: int = NUM_FRAMES, device="cuda", seed: int = 0):
    """(input_ids, patches, grid) of a ``num_frames``-frame 448x252 video
    request."""
    grid_t = num_frames // cfg.vision.temporal_patch_size
    n_video = grid_t * GRID_H * GRID_W // cfg.vision.spatial_merge_size**2
    rng = np.random.default_rng(seed)
    pre = rng.integers(10, 1000, size=16).tolist()
    post = rng.integers(10, 1000, size=48).tolist()  # the "question"
    ids = np.array(
        pre + [cfg.vision_start_token_id] + [cfg.video_token_id] * n_video
        + [cfg.vision_end_token_id] + post,
        dtype=np.int64,
    )
    patches = random_patches(cfg, grid_t * GRID_H * GRID_W, device, seed)
    return ids, patches, np.array([[grid_t, GRID_H, GRID_W]])
