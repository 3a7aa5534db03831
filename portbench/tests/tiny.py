"""Tiny configurations, mixes and cells of the benchmark's own shapes for
the CPU tests (the cells' published widths run only on the chip)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _load(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


TEXT = dict(hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, vocab_size=1100, max_position_embeddings=64,
            rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=False,
            bos_token_id=1000, eos_token_id=1001)


def qwen_config(max_input_length: int = 40) -> dict:
    c = _load("configs", "qwen2-vl-7b")
    c.update(TEXT, vision_start_token_id=1002, vision_end_token_id=1003, vision_token_id=1004,
             image_token_id=1005, video_token_id=1006)
    c["vision_config"] = dict(c["vision_config"], depth=2, embed_dim=32, num_heads=2,
                              hidden_size=64)
    lv = c["retake"]["longvideo_kwargs"]
    lv["frame_chunk_size"] = 4
    lv["chunked_prefill_frames"] = 4
    lv["kvcache_compression_kwargs"]["max_input_length"] = max_input_length
    return c


def llava_config(max_input_length: int = 60) -> dict:
    c = _load("configs", "llava-video-7b")
    c["text_config"] = dict(c["text_config"], **TEXT)
    c.update(image_token_index=1005, video_token_index=1006)
    c["vision_config"] = dict(c["vision_config"], hidden_size=32, intermediate_size=48,
                              num_hidden_layers=2, num_attention_heads=2, image_size=56)
    lv = c["retake"]["longvideo_kwargs"]
    lv["frame_chunk_size"] = 2
    lv["chunked_prefill_frames"] = 2
    lv["kvcache_compression_kwargs"]["max_input_length"] = max_input_length
    return c


def cell(name: str, config: dict, traffic: dict, limit: float = 1e-2) -> dict:
    bench = _bench()
    w = next(w for w in bench["workloads"] if w["name"] == name)
    return dict(name=name, workload=w, config=config, traffic=traffic,
                limits={"logit_err": {"limit": limit}},
                end_to_end=[m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
                per_layer=[m for m in bench["per_layer"] if name in m.get("workloads", [name])])


def _bench() -> dict:
    with open(HERE.parent / "BENCHMARK.json") as f:
        return json.load(f)


def video_qa(frames: int = 16) -> dict:
    t = copy.deepcopy(_load("traffic", "video-qa-1024f"))
    t.update(frames=frames, frame_hw=[56, 56], max_new_tokens=6)
    return t


def serve_clips() -> dict:
    t = copy.deepcopy(_load("traffic", "serve-clips"))
    t.update(frames=[4, 8], output_tokens=[3, 6, 9], frame_hw=[56, 56], rate_per_s=3.0,
             checked_requests=3)
    t["server"] = dict(t["server"], prefill_bucket=8192)
    return t
