"""Checkpoint-gate stage: one golden question through the online serving path
(``runtime/http_server.RetakeHTTPServer`` over a real socket; port of
``tools/gate_http_stage.py``).

The demo and eval stages hold the engine; serving adds its own moving
parts (continuous batching, segment harvest, the vision cache, the worker
thread). This stage shows that the question a user would POST gets the
golden answer through that whole stack.

With ``--hf_path``: the checkpoint and its processor; the first demo
question must be answered "A". With ``--tiny``: the tiny random geometry
and the stub tokenizer (``--device cpu`` runs it on the CPU); the request
must only round-trip: HTTP 200, tokens, ``/metrics`` counting it.

Usage:
  python3 -m retake_tpu_torch.tools.gate_http_stage --hf_path /ckpt --video misc/demo.mp4
  python3 -m retake_tpu_torch.tools.gate_http_stage --tiny --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import urllib.request
from typing import List, Optional

import numpy as np

TIMEOUT_S = 3600


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hf_path", default=None)
    p.add_argument("--config", default="configs/retake_demo.yaml")
    p.add_argument("--video", default=None,
                   help="server-local video file or frame dir; synthesized frames when omitted "
                        "(tiny mode only)")
    p.add_argument("--video_frame_extraction_fps", type=int, default=25,
                   help="the fps a --video frame directory was extracted at")
    p.add_argument("--max_new_tokens", type=int, default=None,
                   help="override the config budget")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.tiny and not (args.hf_path and args.video):
        p.error("--hf_path and --video are required unless --tiny")
    args.random_weights = False  # demo.build's flag
    return args


def record(argv: Optional[List[str]] = None) -> dict:
    """The stage's JSON record: ``answer``, ``expected``, ``status``,
    ``n_tokens``, ``ttft_s``, ``served_total`` and ``ok``."""
    return run(parse_args(argv))


def run(args: argparse.Namespace) -> dict:
    from retake_tpu_torch.data.scorers import trim_answer
    from retake_tpu_torch.demo import DEMO_QUESTIONS, EXPECTED_ANSWERS, build
    from retake_tpu_torch.runtime.http_server import RetakeHTTPServer
    from retake_tpu_torch.utils.config import RetakeConfig

    rt = RetakeConfig.from_yaml(args.config)
    engine, processor = build(args, rt)
    with tempfile.TemporaryDirectory(prefix="gate_http_") as tmp:
        video_path, fps = args.video, args.video_frame_extraction_fps
        if video_path is None:  # the HTTP API loads server-local paths: a frame dir
            from PIL import Image

            rng = np.random.default_rng(0)
            for i in range(8):
                Image.fromarray(rng.integers(0, 255, size=(56, 84, 3), dtype=np.uint8)).save(
                    os.path.join(tmp, f"{i:06d}.jpg"))
            video_path, fps = tmp, 2
        srv = RetakeHTTPServer(engine, processor, rt, port=0, batch_slots=2, segment_steps=4,
                               max_new_tokens=args.max_new_tokens or rt.max_new_tokens,
                               vision_cache_slots=1)
        srv.start()
        try:
            base = f"http://{srv.host}:{srv.port}"
            body = json.dumps({"question": DEMO_QUESTIONS[0], "video_path": video_path,
                               "extraction_fps": fps}).encode()
            req = urllib.request.Request(base + "/v1/generate", data=body, method="POST",
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
                status, resp = r.status, json.loads(r.read())
            with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
                metrics = json.loads(r.read())
        finally:
            srv.shutdown(timeout=60)

    answer = trim_answer(resp.get("text", ""))
    return {
        "answer": answer,
        "expected": EXPECTED_ANSWERS[0],
        "status": status,
        "n_tokens": len(resp.get("tokens", [])),
        "ttft_s": resp.get("ttft_s"),
        "served_total": metrics.get("requests_finished"),
        "ok": (status == 200 and bool(resp.get("tokens")) and not resp.get("cancelled")
               and metrics.get("requests_finished") == 1
               if args.tiny else answer == EXPECTED_ANSWERS[0]),
    }


def main(argv: Optional[List[str]] = None) -> int:
    rec = record(argv)
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
