"""Quantize an HF checkpoint once and save the ready-to-load tree (port of
``tools/quantize_checkpoint.py``).

Engines pointed at ``--out`` (the eval runner's and the demo's
``--hf_path``) find the saved file and skip both the bf16-sized disk read
and the on-device quantization pass at every start (``utils/checkpoint.py``).
The config still controls W8A8 activation quantization at run time: this
bakes the weights only, exactly what ``quantize_llm_int8`` /
``quantize_vit_int8`` / ``quantize_siglip_int8`` produce at engine load.
The output is the JAX tool's format: either package loads it.

Usage:
  python3 -m retake_tpu_torch.tools.quantize_checkpoint --hf_path /ckpt/Qwen2-VL-7B \\
      --out /ckpt/qwen2-vl-7b-int8 --model_name qwen2_vl \\
      [--vit]   # also quantize the vision tower (w8a8 configs)
The weights are loaded and quantized on the card (``--device cpu`` on the
CPU); the last stdout line is ``{"out": ..., "files": [...]}``, and on the
card stderr gets the peak device memory.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import List, Optional

COPIED_FILES = ("config.json", "tokenizer.json", "tokenizer_config.json", "vocab.json",
                "merges.txt")


def quantized_tree(hf_path: str, model_name: str, vit: bool, device) -> dict:
    """The int8 tree of an HF checkpoint, loaded and quantized on
    ``device``."""
    from retake_tpu_torch.ops import quantization as q8

    if model_name == "qwen2_vl":
        from retake_tpu_torch.models.qwen2_vl import params as plib
        from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig

        cfg = Qwen2VLConfig.from_pretrained(hf_path)
        params = q8.quantize_llm_int8(plib.load_safetensors(hf_path, cfg, device=device))
        if vit:
            params["visual"] = q8.quantize_vit_int8(params["visual"])
        return params
    from retake_tpu_torch.models.llava_onevision import params as plib
    from retake_tpu_torch.models.llava_onevision.config import LlavaOnevisionConfig

    cfg = LlavaOnevisionConfig.from_pretrained(hf_path)
    params = q8.quantize_llm_int8(plib.load_safetensors(hf_path, cfg, device=device))
    return q8.quantize_siglip_int8(params) if vit else params


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hf_path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--model_name", default="qwen2_vl",
                   choices=["qwen2_vl", "llava_onevision", "llava_video"])
    p.add_argument("--vit", action="store_true",
                   help="also quantize the vision tower (w8a8 configs)")
    p.add_argument("--device", default="cuda", help="'cuda' or 'cpu'")
    args = p.parse_args(argv)

    import torch

    from retake_tpu_torch import device as device_lib
    from retake_tpu_torch.utils import checkpoint

    dev = device_lib.resolve(args.device)
    params = quantized_tree(args.hf_path, args.model_name, args.vit, dev)
    if dev.type == "cuda":
        print(f"quantize_checkpoint: peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", file=sys.stderr)
    checkpoint.save_params(
        params, args.out,
        meta={"model_name": args.model_name, "weights": "int8",
              "vit_int8": bool(args.vit), "source": args.hf_path},
    )
    # engines still need the HF config (and callers the tokenizer files)
    for fname in COPIED_FILES:
        src = os.path.join(args.hf_path, fname)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.out, fname))
    print(json.dumps({"out": args.out, "files": sorted(os.listdir(args.out))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
