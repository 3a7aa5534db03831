"""TTFT / TPOT measurement, the reference's protocol (port of
``tools/cal_ttft.py``).

Reference (scripts/utils/cal_ttft.py:211-239): TTFT is the mean wall time
of ``generate(max_new_tokens=1)`` over ``--runs`` runs, the first
discarded; TPOT is (wall time of ``--tpot_tokens`` new tokens - TTFT) /
(n - 1). Each timed run ends in ``torch.cuda.synchronize()`` on a card.

With ``--hf_path`` a synthetic 448x252 video of ``--frames`` random frames
goes through the checkpoint's processor (resize, normalize, patchify on the
host) and its tokenizer builds the prompt. With ``--random-weights`` (or no
checkpoint) the model is Qwen2-VL-2B with random weights and the request
the bench request (``tools/bench_model.py``); ``--tiny`` takes the tiny
geometry and the stub tokenizer (``--device cpu`` runs on the CPU).

Usage:
  python3 -m retake_tpu_torch.tools.cal_ttft --config configs/retake_demo.yaml \\
      [--hf_path /path/to/ckpt | --random-weights] [--frames 256]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hf_path", type=str, default=None)
    p.add_argument("--config", type=str, default="configs/retake_demo.yaml")
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--tpot_tokens", type=int, default=512)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--tiny", action="store_true", help="tiny random geometry")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if args.runs < 2:
        p.error("--runs must be at least 2: the first run is discarded")
    return args


def record(argv: Optional[List[str]] = None) -> dict:
    """The measurement's JSON record: ``ttft_s``, ``ttft_runs_s``,
    ``tpot_ms``, ``tpot_tokens`` (generated), ``tpot_total_s``, the
    request's ``input_tokens`` and the config's ``attn_implementation``."""
    return run(parse_args(argv))


def build(args: argparse.Namespace, rt):
    """(engine, input_ids, patches, grid): the checkpoint's or the tiny
    model with a processed random video (``args.hf_path`` / ``args.tiny``),
    else the bench model and request; ``args.frames`` frames."""
    from retake_tpu_torch import device as device_lib

    dev = device_lib.resolve(args.device)
    if args.tiny or (args.hf_path and not args.random_weights):
        from retake_tpu_torch.demo import build as build_demo

        engine, processor = build_demo(args, rt)
        rng = np.random.default_rng(0)
        size = (56, 84, 3) if args.tiny else (252, 448, 3)
        video = rng.integers(0, 256, size=(args.frames,) + size, dtype=np.uint8)
        inputs = processor("Describe the video.", list(video))
        return (engine, inputs["input_ids"], inputs["pixel_values_videos"],
                inputs["video_grid_thw"])
    from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine
    from retake_tpu_torch.tools.bench_model import build_model, build_request

    cfg, params = build_model(dev)
    engine = Qwen2VLEngine(cfg, Qwen2VLModel(cfg, params), rt, device=dev)
    return (engine,) + build_request(cfg, args.frames, dev, 0)


def run(args: argparse.Namespace) -> dict:
    import torch

    from retake_tpu_torch.utils.config import RetakeConfig

    rt = RetakeConfig.from_yaml(args.config)
    engine, ids, patches, grid = build(args, rt)
    sync = torch.cuda.synchronize if engine.device.type == "cuda" else (lambda: None)

    def timed(max_new_tokens: int):
        t0 = time.perf_counter()
        r = engine.generate(ids, patches, grid, max_new_tokens=max_new_tokens)
        sync()
        return time.perf_counter() - t0, r

    times = [timed(1)[0] for _ in range(args.runs)]  # the first warms the caches
    ttft = float(np.mean(times[1:]))
    print(f"TTFT @ {args.frames} frames: {ttft:.3f}s (runs: {[round(t, 3) for t in times]})")
    total, r = timed(args.tpot_tokens)
    n = len(r.tokens)
    tpot = (total - ttft) / max(n - 1, 1)
    print(f"TPOT: {tpot * 1000:.1f} ms/token ({n} tokens in {total:.2f}s)")
    return {"frames": args.frames, "input_tokens": int(len(ids)),
            "attn_implementation": rt.attn_implementation, "ttft_s": ttft,
            "ttft_runs_s": times, "tpot_ms": tpot * 1000, "tpot_tokens": n,
            "tpot_total_s": total}


def main(argv: Optional[List[str]] = None) -> int:
    print(json.dumps(record(argv)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
