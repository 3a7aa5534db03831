"""Shared helpers for the port-vs-JAX parity tests (tests/test_torch_*.py).

Both packages get the same inputs, drawn from a numpy seed, and the same
weights: the JAX init goes through the port's weight bridge
(``retake_tpu_torch.models.qwen2_vl.params.from_jax_params``).
"""

import dataclasses

import jax
import numpy as np
import torch

from retake_tpu.models.qwen2_vl.config import Qwen2VisionConfig, Qwen2VLConfig
from retake_tpu_torch.models.qwen2_vl import config as tconfig
from retake_tpu_torch.models.qwen2_vl import params as tparams

# the tiny model of tests/test_engine.py (its `tiny` fixture's config)
VIS = dict(
    depth=2, embed_dim=32, hidden_size=64, mlp_ratio=2, num_heads=2,
    in_channels=3, patch_size=2, spatial_merge_size=2, temporal_patch_size=2,
)
TINY = dict(
    vocab_size=512, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    max_position_embeddings=4096, rope_theta=10000.0,
    mrope_section=(4, 2, 2), tie_word_embeddings=False,
    bos_token_id=0, eos_token_id=1,
    vision_start_token_id=3, vision_end_token_id=4,
    image_token_id=5, video_token_id=6,
)


def tiny_cfg(**overrides) -> Qwen2VLConfig:
    return Qwen2VLConfig(**{**TINY, **overrides, "vision": Qwen2VisionConfig(**VIS)})


def port_cfg(cfg: Qwen2VLConfig) -> tconfig.Qwen2VLConfig:
    """The port's config with the same fields as a JAX config."""
    d = dataclasses.asdict(cfg)
    d["vision"] = tconfig.Qwen2VisionConfig(**d["vision"])
    return tconfig.Qwen2VLConfig(**d)


def port_params(jax_params) -> dict:
    return tparams.from_jax_params(jax.tree.map(np.asarray, jax_params))


def tt(x) -> torch.Tensor:
    """numpy / JAX array -> torch tensor (copied)."""
    return torch.from_numpy(np.array(x))


def npy(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def video_request(cfg, rng, grid_t=2, grid_h=4, grid_w=4, prompt_len=5):
    """input_ids with one video span + random pixel patches (as in
    tests/test_engine.py make_video_request)."""
    m2 = cfg.vision.spatial_merge_size**2
    n_video_tokens = grid_t * grid_h * grid_w // m2
    pre = rng.integers(10, 500, size=3).tolist()
    post = rng.integers(10, 500, size=prompt_len).tolist()
    ids = np.array(
        pre + [cfg.vision_start_token_id] + [cfg.video_token_id] * n_video_tokens
        + [cfg.vision_end_token_id] + post,
        dtype=np.int64,
    )
    patches = rng.normal(size=(grid_t * grid_h * grid_w, cfg.vision.patch_input_dim))
    return ids, patches.astype(np.float32), np.array([[grid_t, grid_h, grid_w]])
