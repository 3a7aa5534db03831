"""End-to-end demo of the port: long-video QA with ReTaKe on one GPU.

The flow of the repository's ``demo.py``: a ``--config`` YAML
(``RetakeConfig.from_yaml``), a Qwen2-VL checkpoint (``--hf_path``: HF
safetensors, or a pre-quantized directory written by
``tools/quantize_checkpoint.py``), a video sampled at the configured fps and
resolution (or random frames), the vision tower and the video prefill
encoded once (``encode_video``, ``encode_prefix``), then the three golden
multiple-choice questions (expected A, B, C), each through
``generate(prefix=...)``.

Without a checkpoint, ``--random-weights`` runs the whole pipeline at the
2B geometry on random weights (the answers are meaningless), and ``--tiny``
at a tiny geometry; ``--device cpu`` runs on the CPU (the default is the
GPU, ``cuda``). ``--spec`` turns on prompt-lookup speculative decoding and
``--no-reuse`` recomputes vision and the prefill for every question: the
first-checkpoint gate (``tools/first_checkpoint_gate.py``) holds both to the
default run. ``--video`` may be a video file or a frame directory (JPEG
frames extracted at ``--video_frame_extraction_fps``).

Usage:
  python3 -m retake_tpu_torch.demo --hf_path /path/to/Qwen2-VL-7B-Instruct \\
      --config configs/retake_demo.yaml --video my_video.mp4
  python3 -m retake_tpu_torch.demo --random-weights --frames 64 --json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional

import numpy as np

from retake_tpu_torch.data.scorers import trim_answer

DEMO_QUESTIONS = [
    "As depicted in the video, how is the relationship between the rabbit and"
    " human?\nOptions:\nA. Hostile.\nB. Friend.\nC. Cooperator.\nD. No one is"
    " correct above.\nAnswer with the option's letter from the given choices"
    " directly.",
    "What is the impression of the video?\nOptions:\nA. Sad.\nB. Funny.\nC."
    " Horrible.\nD. Silent.\nAnswer with the option's letter from the given"
    " choices directly.",
    "What is the subject of the video?\nOptions:\nA. Rabbit likes to eat"
    " carrots.\nB. How to raise a rabbit.\nC. A rabbit gives people trouble."
    "\nD. A rabbit performs for food.\nAnswer with the option's letter from"
    " the given choices directly.",
]
EXPECTED_ANSWERS = ["A", "B", "C"]


class StubTokenizer:
    """Byte-level stand-in for runs without tokenizer files: ids in
    [first, vocab)."""

    def __init__(self, vocab: int, first: int = 7):
        self.first, self.span = first, min(1000, vocab - first)

    def encode(self, s):
        return [self.first + (b % self.span) for b in s.encode()][:512]

    def decode(self, ids, **kw):
        return " ".join(str(i) for i in ids)


def tiny_config():
    """A tiny Qwen2-VL geometry (2 layers, hidden 64) whose special token
    ids lie inside its 512-token vocabulary."""
    from retake_tpu_torch.models.qwen2_vl.config import Qwen2VisionConfig, Qwen2VLConfig

    return Qwen2VLConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, mrope_section=(4, 2, 2),
        bos_token_id=0, eos_token_id=1, vision_start_token_id=3, vision_end_token_id=4,
        image_token_id=5, video_token_id=6,
        vision=Qwen2VisionConfig(depth=2, embed_dim=32, hidden_size=64, mlp_ratio=2, num_heads=2),
    )


def stub_processor(cfg, **kw):
    """A processor with the byte-level stub tokenizer and ``cfg``'s ids."""
    from retake_tpu_torch.data.processor import Qwen2VLProcessor

    return Qwen2VLProcessor(
        StubTokenizer(cfg.vocab_size), vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id, video_token_id=cfg.video_token_id,
        image_token_id=cfg.image_token_id, patch_size=cfg.vision.patch_size,
        merge_size=cfg.vision.spatial_merge_size,
        temporal_patch_size=cfg.vision.temporal_patch_size, **kw,
    )


def build(args, rt):
    """(engine, processor) for the arguments."""
    import torch

    from retake_tpu_torch import device as device_lib
    from retake_tpu_torch.data.processor import Qwen2VLProcessor
    from retake_tpu_torch.models.qwen2_vl import params as params_lib
    from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig, qwen2_vl_2b
    from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine
    from retake_tpu_torch.utils import checkpoint

    dev = device_lib.resolve(args.device)
    if args.tiny:
        print("== tiny random-geometry dry-run mode ==")
        cfg = tiny_config()
        params = params_lib.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
        processor = stub_processor(cfg, min_pixels=1)
    elif args.random_weights or not args.hf_path:
        print("== random-weights smoke mode (no checkpoint) ==")
        cfg = qwen2_vl_2b()
        params = params_lib.init_params(cfg, seed=0, device=dev)
        processor = stub_processor(cfg)
    else:
        cfg = Qwen2VLConfig.from_pretrained(args.hf_path)
        if checkpoint.has_params(args.hf_path):  # tools/quantize_checkpoint.py output
            params = checkpoint.load_checked(args.hf_path, rt, "qwen2_vl", device=dev)
        else:
            params = params_lib.load_safetensors(args.hf_path, cfg, device=dev)
        processor = Qwen2VLProcessor.from_pretrained(args.hf_path)
    engine = Qwen2VLEngine(cfg, Qwen2VLModel(cfg, params), rt, device=dev)
    return engine, processor


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hf_path", type=str, default=None)
    p.add_argument("--config", type=str, default="configs/retake_demo.yaml")
    p.add_argument("--video", type=str, default=None)
    p.add_argument("--video_frame_extraction_fps", type=int, default=25,
                   help="the fps a --video frame directory was extracted at")
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--frames", type=int, default=None,
                   help="synthetic frame count when no --video is given")
    p.add_argument("--json", action="store_true",
                   help="also print one JSON line: answers against the expected ones")
    p.add_argument("--spec", action="store_true",
                   help="prompt-lookup speculative decoding (spec_decode: true)")
    p.add_argument("--no-reuse", action="store_true",
                   help="run vision and the whole prefill for every question")
    p.add_argument("--max_new_tokens", type=int, default=None,
                   help="token budget of each answer (default: the config's)")
    p.add_argument("--tiny", action="store_true", help="tiny random geometry")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def record(argv: Optional[List[str]] = None) -> dict:
    """Run the demo; returns its JSON record (``answers``, ``expected``,
    ``golden_pass``, ``tokens``)."""
    return run(parse_args(argv))


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    rec = run(args)
    if args.json:
        print(json.dumps(rec))
    return 0


def run(args: argparse.Namespace) -> dict:
    from retake_tpu_torch.data.video import fetch_video
    from retake_tpu_torch.runtime.engine import PrefixMismatch
    from retake_tpu_torch.utils.config import RetakeConfig

    rt = RetakeConfig.from_yaml(args.config)
    if args.spec:
        rt = dataclasses.replace(rt, spec_decode=True)
    if args.max_new_tokens:
        rt = dataclasses.replace(rt, max_new_tokens=args.max_new_tokens)
    engine, processor = build(args, rt)
    if args.video:
        frames = fetch_video(args.video, rt.max_num_frames, rt.sample_fps, rt.longsize_resolution,
                             extraction_fps=args.video_frame_extraction_fps)
    else:
        n = args.frames or (8 if args.tiny else 64)
        print(f"no --video given: synthesizing {n} random frames")
        rng = np.random.default_rng(0)
        size = (56, 84, 3) if args.tiny else (252, 448, 3)
        frames = [rng.integers(0, 255, size=size, dtype=np.uint8) for _ in range(n)]

    # the three questions share the video: vision and the video prefill run
    # once (a VideoPrefix); each question runs its text segment and decode
    features = prefix = grid = None
    answers, token_streams = [], []
    for question, expected in zip(DEMO_QUESTIONS, EXPECTED_ANSWERS):
        t0 = time.perf_counter()
        if args.no_reuse:
            inputs = processor(question, frames)
            result = engine.generate(inputs["input_ids"], inputs["pixel_values_videos"],
                                     inputs["video_grid_thw"], max_new_tokens=rt.max_new_tokens)
        else:
            if features is None:
                inputs = processor(question, frames)
                grid = inputs["video_grid_thw"]
                features = engine.encode_video(inputs["pixel_values_videos"], grid)
                try:
                    prefix = engine.encode_prefix(inputs["input_ids"], video_features=features,
                                                  max_new_tokens=rt.max_new_tokens)
                except ValueError as e:
                    print(f"[prefix capture unavailable: {e}]")
                print(f"[vision + video prefill encoded once: {time.perf_counter() - t0:.1f}s, "
                      "reused below]")
                t0 = time.perf_counter()
            else:
                inputs = processor(question, video_grid=grid[0])
            result = None
            if prefix is not None:
                try:
                    result = engine.generate(inputs["input_ids"], prefix=prefix,
                                             max_new_tokens=rt.max_new_tokens)
                except PrefixMismatch as e:
                    print(f"[prefix fallback: {e}]")
            if result is None:
                result = engine.generate(inputs["input_ids"], video_features=features,
                                         max_new_tokens=rt.max_new_tokens)
        dt = time.perf_counter() - t0
        decoded = processor.decode(result.tokens)
        answers.append(trim_answer(decoded))
        token_streams.append([int(t) for t in result.tokens])
        print(f"\nQ: {question.splitlines()[0]}")
        print(f"A: {decoded!r}")
        print(f"expected: {expected}")
        print(f"[{dt:.1f}s total | prefill {result.prefill_seconds:.1f}s | input "
              f"{result.input_len} tok -> cache {result.cache_len} tok]")
    return {"answers": answers, "expected": EXPECTED_ANSWERS,
            "golden_pass": answers == EXPECTED_ANSWERS, "tokens": token_streams}


if __name__ == "__main__":
    sys.exit(main())
