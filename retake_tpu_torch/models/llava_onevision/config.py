"""LLaVA-OneVision / LLaVA-Video configuration (Qwen2 text + SigLIP tower),
jax-free copy of ``retake_tpu/models/llava_onevision/config.py`` (same
fields, defaults and HF parsing; ``tests/test_torch_config.py`` pins the
two field for field).

The original mirrors the HF LlavaOnevisionConfig surface the reference patches
(retake/monkeypatch.py:37-48) and the converter's hardcoded SigLIP so400m
geometry (scripts/utils/convert_llava_video_weights_to_hf.py:121-129):
hidden 1152, 26 layers, heads 16, mlp 4304, image 384, patch 14, no head.
The text decoder reuses the Qwen2 stack with 1-D RoPE (mrope_section=None).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 26
    num_attention_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size  # 27

    @property
    def num_patches(self) -> int:
        return self.grid**2  # 729


@dataclasses.dataclass(frozen=True)
class LlavaOnevisionConfig:
    text: Qwen2VLConfig = dataclasses.field(
        default_factory=lambda: Qwen2VLConfig(mrope_section=None)
    )
    vision: SiglipVisionConfig = dataclasses.field(
        default_factory=SiglipVisionConfig
    )
    image_token_id: int = 151646
    video_token_id: int = 151647
    vision_feature_layer: int = -1
    vision_feature_select_strategy: str = "full"
    pool_stride: int = 2  # hardcoded in the reference (llava_onevision.py:330)
    # anyres still-image packing (reference llava_onevision.py:383-416);
    # default pinpoints are the HF llava-onevision 384px grid set
    image_grid_pinpoints: tuple = tuple(
        (h * 384, w * 384) for h in range(1, 7) for w in range(1, 7)
    )
    vision_aspect_ratio: str = "anyres_max_9"

    @property
    def pooled_grid(self) -> int:
        return math.ceil(self.grid_side / self.pool_stride)

    @property
    def grid_side(self) -> int:
        return self.vision.grid

    @property
    def tokens_per_frame(self) -> int:
        return self.pooled_grid**2  # 196 for so400m-384

    @staticmethod
    def from_hf_dict(d: dict) -> "LlavaOnevisionConfig":
        tc = d.get("text_config", {})
        rope_scaling = tc.get("rope_scaling") or {}
        yarn_factor = None
        if rope_scaling.get("rope_type") == "yarn":
            yarn_factor = float(rope_scaling.get("factor", 1.0))
        text = Qwen2VLConfig(
            vocab_size=tc.get("vocab_size", 152128),
            hidden_size=tc.get("hidden_size", 3584),
            intermediate_size=tc.get("intermediate_size", 18944),
            num_hidden_layers=tc.get("num_hidden_layers", 28),
            num_attention_heads=tc.get("num_attention_heads", 28),
            num_key_value_heads=tc.get("num_key_value_heads", 4),
            rms_norm_eps=tc.get("rms_norm_eps", 1e-6),
            rope_theta=tc.get("rope_theta", 1000000.0),
            max_position_embeddings=tc.get("max_position_embeddings", 32768),
            tie_word_embeddings=tc.get("tie_word_embeddings", False),
            mrope_section=None,  # 1-D RoPE
            yarn_factor=yarn_factor,
            bos_token_id=tc.get("bos_token_id", 151643),
            eos_token_id=tc.get("eos_token_id", 151645),
        )
        vc = d.get("vision_config", {})
        vision = SiglipVisionConfig(
            hidden_size=vc.get("hidden_size", 1152),
            intermediate_size=vc.get("intermediate_size", 4304),
            num_hidden_layers=vc.get("num_hidden_layers", 26),
            num_attention_heads=vc.get("num_attention_heads", 16),
            image_size=vc.get("image_size", 384),
            patch_size=vc.get("patch_size", 14),
        )
        return LlavaOnevisionConfig(
            text=text,
            vision=vision,
            image_token_id=d.get("image_token_index", 151646),
            video_token_id=d.get("video_token_index", 151647),
            vision_feature_layer=d.get("vision_feature_layer", -1),
            vision_feature_select_strategy=d.get(
                "vision_feature_select_strategy", "full"
            ),
            image_grid_pinpoints=tuple(
                tuple(p) for p in d.get(
                    "image_grid_pinpoints",
                    LlavaOnevisionConfig.image_grid_pinpoints,
                )
            ),
            vision_aspect_ratio=d.get("vision_aspect_ratio", "anyres_max_9"),
        )

    @staticmethod
    def from_pretrained(path: str) -> "LlavaOnevisionConfig":
        with open(os.path.join(path, "config.json")) as f:
            return LlavaOnevisionConfig.from_hf_dict(json.load(f))

    def with_yarn(self, factor: float) -> "LlavaOnevisionConfig":
        return dataclasses.replace(self, text=self.text.with_yarn(factor))
