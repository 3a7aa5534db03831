"""Qwen2-VL configuration dataclasses, jax-free copy.

Field-for-field copy of ``retake_tpu/models/qwen2_vl/config.py`` (same names,
defaults and properties) so the port runs where the JAX package is absent.
``tests/test_torch_config.py`` pins the two to identical fields.
``rope_params`` lives in ``params.py``: the JAX class's method imports jax.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Qwen2VisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    hidden_size: int = 3584  # output (LLM) hidden size after merger
    mlp_ratio: int = 4
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_input_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2


@dataclasses.dataclass(frozen=True)
class Qwen2VLConfig:
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = False
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    yarn_factor: Optional[float] = None
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    bos_token_id: int = 151643
    eos_token_id: int = 151645
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision: Qwen2VisionConfig = dataclasses.field(default_factory=Qwen2VisionConfig)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    def with_yarn(self, factor: float) -> "Qwen2VLConfig":
        """Enable YaRN context extension (reference 'scaling_factor' knob)."""
        return dataclasses.replace(self, yarn_factor=float(factor))


def qwen2_vl_2b() -> Qwen2VLConfig:
    """Qwen2-VL-2B geometry (the bench model): 28 layers, hidden 1536,
    12 query / 2 KV heads of 128, tied embeddings, ViT 32 x 1280."""
    return Qwen2VLConfig(
        vocab_size=151936,
        hidden_size=1536,
        intermediate_size=8960,
        num_hidden_layers=28,
        num_attention_heads=12,
        num_key_value_heads=2,
        tie_word_embeddings=True,
        vision=Qwen2VisionConfig(hidden_size=1536),
    )


def qwen2_vl_7b() -> Qwen2VLConfig:
    """Qwen2-VL-7B geometry (the JAX default ``Qwen2VLConfig()``): 28 layers,
    hidden 3584, intermediate 18944, 28 query / 4 KV heads of 128, vocab
    152064, untied LM head, ViT 32 x 1280 projecting to 3584."""
    return Qwen2VLConfig()
