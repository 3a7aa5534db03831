"""ReTaKe experiment configuration, jax-free copy.

Copy of ``RetakeConfig`` / ``from_dict`` / ``compression_ratio_for`` from
``retake_tpu/utils/config.py`` (same fields, defaults and parsing rules) so
the port runs without the JAX package; YAML loading is left out because the
port's entry points take dicts. ``tests/test_torch_config.py`` checks that
both parse the same dicts to equal fields.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class VisualCompressionConfig:
    compression_ratio: float = 1.0
    compression_method: str = "Keyframe"  # Keyframe | MA-LLM | MA-LLM-hard
    patch_sync: bool = False
    return_keyframe_mask: bool = True


@dataclasses.dataclass
class KVCompressionConfig:
    compression_method: str = "pivotkv"
    compression_ratio: Optional[float] = None  # fixed ratio, or None
    dynamic_compression_ratio: bool = False
    max_input_length: Optional[int] = None
    pos_embed_reforge: bool = False
    prompt_guided_compression: bool = False


@dataclasses.dataclass
class RetakeConfig:
    model_name: str = "qwen2_vl"
    method: str = "retake"
    scaling_factor: Optional[float] = None  # YaRN factor; None = disabled
    # "pallas": the hand-written kernels (K1/K2/K3) on CUDA tensors;
    # "flash": blocked online-softmax prefill attention in plain torch (K3
    # in the ViT); "xla": the plain torch path (masked full attention,
    # eviction_scores)
    attn_implementation: str = "pallas"
    frame_chunk_size: Optional[int] = None  # ViT chunking (grid_t units)
    chunked_prefill_frames: Optional[int] = None  # LLM chunk (raw frames)
    visual_compression: bool = False
    visual: VisualCompressionConfig = dataclasses.field(
        default_factory=VisualCompressionConfig
    )
    kvcache_compression: bool = False
    kv: KVCompressionConfig = dataclasses.field(default_factory=KVCompressionConfig)
    # data
    dataset_name: Optional[str] = None
    anno_file: Optional[str] = None
    dataloader_num_workers: int = 0
    sample_fps: float = 4.0
    max_num_frames: int = 2048
    longsize_resolution: int = 448
    # generate
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0
    max_new_tokens: int = 128
    output_dir: Optional[str] = None
    quantization: Optional[str] = None  # None | "int8" | "w8a8"
    kv_cache_dtype: Optional[str] = None  # None (bf16) | "int8"
    eval_batch_size: int = 1
    decode_early_stop: bool = True
    spec_decode: bool = False
    spec_ngram: int = 3
    spec_draft: int = 8
    reuse_video_features: bool = False
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "RetakeConfig":
        d = dict(d)
        lv = d.pop("longvideo_kwargs", {}) or {}
        vc_kwargs = lv.get("visual_compression_kwargs", {}) or {}
        kv_kwargs = lv.get("kvcache_compression_kwargs", {}) or {}
        known = {
            "model_name", "method", "scaling_factor", "attn_implementation",
            "quantization", "kv_cache_dtype", "eval_batch_size",
            "decode_early_stop", "reuse_video_features", "spec_decode",
            "spec_ngram", "spec_draft", "dataset_name", "anno_file",
            "dataloader_num_workers", "sample_fps", "max_num_frames",
            "longsize_resolution", "do_sample", "temperature", "top_p",
            "top_k", "seed", "max_new_tokens", "output_dir",
        }
        kwargs = {k: v for k, v in d.items() if k in known}
        extras = {k: v for k, v in d.items() if k not in known}
        if kwargs.get("quantization") not in (None, "int8", "w8a8"):
            raise ValueError(
                f"quantization={kwargs['quantization']!r}: expected "
                "null | int8 | w8a8"
            )
        if kwargs.get("kv_cache_dtype") not in (None, "int8"):
            raise ValueError(
                f"kv_cache_dtype={kwargs['kv_cache_dtype']!r}: expected "
                "null | int8"
            )
        if kwargs.get("spec_decode") and kwargs.get("do_sample"):
            raise ValueError(
                "spec_decode is greedy-only (verification compares against "
                "argmax); disable do_sample or spec_decode"
            )
        if kwargs.get("attn_implementation") in (
            "flash_attention_2", "sdpa", "eager",
        ):
            # the reference's GPU attention names map to the kernel path
            kwargs["attn_implementation"] = "pallas"
        return RetakeConfig(
            frame_chunk_size=lv.get("frame_chunk_size"),
            chunked_prefill_frames=lv.get("chunked_prefill_frames"),
            visual_compression=bool(lv.get("visual_compression", False)),
            visual=VisualCompressionConfig(
                compression_ratio=vc_kwargs.get("compression_ratio", 1.0),
                compression_method=vc_kwargs.get("compression_method", "Keyframe"),
                patch_sync=bool(vc_kwargs.get("patch_sync", False)),
                return_keyframe_mask=bool(
                    vc_kwargs.get("return_keyframe_mask", True)
                ),
            ),
            kvcache_compression=bool(lv.get("kvcache_compression", False)),
            kv=KVCompressionConfig(
                compression_method=kv_kwargs.get("compression_method", "pivotkv"),
                compression_ratio=kv_kwargs.get("compression_ratio"),
                dynamic_compression_ratio=bool(
                    kv_kwargs.get("dynamic_compression_ratio", False)
                ),
                max_input_length=kv_kwargs.get("max_input_length"),
                pos_embed_reforge=bool(kv_kwargs.get("pos_embed_reforge", False)),
                prompt_guided_compression=bool(
                    kv_kwargs.get("prompt_guided_compression", False)
                ),
            ),
            extras=extras,
            **kwargs,
        )

    def compression_ratio_for(self, input_length: int) -> float:
        """Effective KV compression ratio for a request (reference dynamic
        rule, qwen2_vl.py:550-557)."""
        if not self.kvcache_compression:
            return 1.0
        if self.kv.dynamic_compression_ratio:
            assert self.kv.max_input_length is not None
            if input_length <= self.kv.max_input_length:
                return 1.0
            return self.kv.max_input_length / input_length
        return self.kv.compression_ratio if self.kv.compression_ratio else 1.0
