"""Quantization accuracy ablation: bf16 vs int8 vs w8a8 vs +int8-KV (port
of ``tools/quant_ablation.py``).

Runs the same video request through the Qwen2-VL engine under each
quantization mode and reports greedy-token agreement against the bf16
reference. Meant for real checkpoints (``--hf_path``): the gate before
enabling w8a8 or an int8 KV cache in a serving config. With
``--random-weights`` (Qwen2-VL-2B geometry) it only drives the five engine
paths: random logits are near-uniform, so the agreements mean nothing
there. Each mode's model is freed before the next is built.

The request is the bench request (``tools/bench_model.py``) at ``--frames``
frames, also with a checkpoint. The config's attention is the kernels
(``"pallas"``): on a CUDA card the bf16 and int8-weight modes run K1, the
int8-KV modes K1's int8 mode, every mode K3 in the ViT.

Usage:
  python3 -m retake_tpu_torch.tools.quant_ablation --hf_path /ckpt/Qwen2-VL-2B-Instruct \\
      --frames 256 --max-new-tokens 64 --json
  python3 -m retake_tpu_torch.tools.quant_ablation --random-weights   # path smoke test
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np

MODES = [
    ("bf16", dict()),
    ("int8-weights", dict(quantization="int8")),
    ("w8a8", dict(quantization="w8a8")),
    ("int8kv-only", dict(kv_cache_dtype="int8")),  # isolates the KV-cache loss
    ("w8a8+int8kv", dict(quantization="w8a8", kv_cache_dtype="int8")),
]


def build_rt(extra: dict):
    from retake_tpu_torch.utils.config import RetakeConfig

    base = {
        "scaling_factor": 4,
        "longvideo_kwargs": {
            "frame_chunk_size": 64,
            "chunked_prefill_frames": 32,
            "visual_compression": True,
            "visual_compression_kwargs": {
                "compression_ratio": 1.0,
                "compression_method": "Keyframe",
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
    base.update(extra)
    return RetakeConfig.from_dict(base)


def run_modes(cfg, params_bf: dict, ids, patches, grid, max_new_tokens: int, device) -> dict:
    """Each of MODES on one request: its tokens, TTFT and (quantized modes)
    greedy agreement with the bf16 tokens over the common length."""
    import torch

    from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
    from retake_tpu_torch.ops.quantization import quantize_llm_int8, quantize_vit_int8
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine

    reference = None
    agreements, tokens, ttft = {}, {}, {}
    for name, extra in MODES:
        if extra.get("quantization") in ("int8", "w8a8"):
            params = quantize_llm_int8(params_bf)
            if extra["quantization"] == "w8a8":
                params["visual"] = quantize_vit_int8(params["visual"])
        else:
            params = params_bf
        eng = Qwen2VLEngine(cfg, Qwen2VLModel(cfg, params), build_rt(extra), device=device)
        r = eng.generate(ids, patches, grid, max_new_tokens=max_new_tokens)
        toks = np.asarray(r.tokens)
        tokens[name], ttft[name] = toks.tolist(), r.prefill_seconds
        if reference is None:
            reference = toks
            print(f"{name:>14}: {len(toks)} tokens (reference) ttft={r.prefill_seconds:.2f}s")
        else:
            n = min(len(toks), len(reference))
            agree = float(np.mean(toks[:n] == reference[:n]))
            agreements[name] = round(agree, 4)
            print(f"{name:>14}: token agreement vs bf16 = {agree:.3f} ({n} compared) "
                  f"ttft={r.prefill_seconds:.2f}s")
        del eng, params, r
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return {"agreement_vs_bf16": agreements, "tokens": tokens, "ttft_s": ttft}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hf_path", type=str, default=None)
    p.add_argument("--random-weights", action="store_true")
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--json", action="store_true",
                   help="also print one JSON line of agreements (read by "
                        "tools/first_checkpoint_gate.py)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def record(argv: Optional[List[str]] = None) -> dict:
    """The ablation's JSON record: ``agreement_vs_bf16`` per quantized mode,
    ``meaningful`` (real weights), each mode's ``tokens`` and ``ttft_s``."""
    return run(parse_args(argv))


def run(args: argparse.Namespace) -> dict:
    from retake_tpu_torch import device as device_lib
    from retake_tpu_torch.tools.bench_model import build_model, build_request

    dev = device_lib.resolve(args.device)
    if args.random_weights or not args.hf_path:
        print("== random weights (2B geometry): smoke test only ==")
        cfg, params_bf = build_model(dev)
    else:
        from retake_tpu_torch.models.qwen2_vl import params as params_lib
        from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig

        cfg = Qwen2VLConfig.from_pretrained(args.hf_path)
        params_bf = params_lib.load_safetensors(args.hf_path, cfg, device=dev)
    ids, patches, grid = build_request(cfg, args.frames, dev, 0)
    rec = run_modes(cfg, params_bf, ids, patches, grid, args.max_new_tokens, dev)
    rec["meaningful"] = bool(args.hf_path and not args.random_weights)
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    rec = run(args)
    if args.json:
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
