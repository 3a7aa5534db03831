"""Checkpoint-gate stage: decode-kernel serving parity, plain vs kernel (port
of ``tools/gate_serve_decode_stage.py``).

The three demo questions are served through ``ContinuousServer`` twice,
under ``decode_attn_impl="xla"`` (the plain einsum arm) and ``"pallas"``
(K4, the gap-layout decode kernel, on a CUDA card; its plain twin on the
CPU), with ``batch_slots=2`` so admissions overlap and the gapped
(mixed-fill) decode runs. K4's flash-order sums are not bit-exact against
the plain arm, so an argmax can flip in principle; this stage shows that
it does not change the answers.

With ``--hf_path``: both arms must give the golden letters A, B, C. With
``--tiny``: the tiny random geometry (``--device cpu`` runs it on the
CPU); random weights sit at near-ties where the summation order flips
argmaxes, so the criterion is both arms running to the end with aggregate
token agreement >= 0.7.

Usage:
  python3 -m retake_tpu_torch.tools.gate_serve_decode_stage --hf_path /ckpt \\
      --video misc/demo.mp4
  python3 -m retake_tpu_torch.tools.gate_serve_decode_stage --tiny --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np

MIN_TINY_AGREEMENT = 0.7


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hf_path", default=None)
    p.add_argument("--config", default="configs/retake_demo.yaml")
    p.add_argument("--video", default=None,
                   help="video file or frame dir; synthesized frames when omitted (tiny mode only)")
    p.add_argument("--video_frame_extraction_fps", type=int, default=25,
                   help="the fps a --video frame directory was extracted at")
    p.add_argument("--max_new_tokens", type=int, default=None,
                   help="override the config budget (tiny mode trims it to 8)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not args.tiny and not args.hf_path:
        p.error("--hf_path is required unless --tiny")
    if not args.tiny and not args.video:
        p.error("--video is required with --hf_path")
    args.random_weights = False  # demo.build's flag
    return args


def token_agreement(a: List[List[int]], b: List[List[int]]) -> float:
    """Positions where the streams agree over the longer stream's length,
    summed over requests."""
    agree = total = 0
    for x, y in zip(a, b):
        n = min(len(x), len(y))
        agree += sum(int(p == q) for p, q in zip(x[:n], y[:n]))
        total += max(len(x), len(y))
    return agree / max(total, 1)


def record(argv: Optional[List[str]] = None) -> dict:
    """The stage's JSON record: ``answers_xla`` / ``answers_pallas``,
    ``expected``, ``token_exact``, ``token_agreement``, ``streams`` and
    ``ok``."""
    return run(parse_args(argv))


def run(args: argparse.Namespace) -> dict:
    from retake_tpu_torch.data.scorers import trim_answer
    from retake_tpu_torch.data.video import fetch_video
    from retake_tpu_torch.demo import DEMO_QUESTIONS, EXPECTED_ANSWERS, build
    from retake_tpu_torch.runtime.serve import ContinuousServer
    from retake_tpu_torch.utils.config import RetakeConfig

    rt = RetakeConfig.from_yaml(args.config)
    engine, processor = build(args, rt)
    if args.video:
        frames = fetch_video(args.video, rt.max_num_frames, rt.sample_fps,
                             rt.longsize_resolution, extraction_fps=args.video_frame_extraction_fps)
    else:
        rng = np.random.default_rng(0)
        frames = [rng.integers(0, 255, size=(56, 84, 3), dtype=np.uint8) for _ in range(8)]
    reqs = []
    for question in DEMO_QUESTIONS:
        inputs = processor(question, frames)
        reqs.append({k: v for k, v in inputs.items() if v is not None})

    max_new = args.max_new_tokens or (8 if args.tiny else rt.max_new_tokens)
    streams = {}
    for impl in ("xla", "pallas"):
        server = ContinuousServer(engine, batch_slots=2, segment_steps=4, max_new_tokens=max_new,
                                  decode_attn_impl=impl)
        results = server.run([dict(r) for r in reqs])
        streams[impl] = [[int(t) for t in r.tokens] for r in results]

    answers = {impl: [trim_answer(processor.tokenizer.decode(t)) for t in toks]
               for impl, toks in streams.items()}
    rec = {
        "answers_xla": answers["xla"],
        "answers_pallas": answers["pallas"],
        "expected": list(EXPECTED_ANSWERS),
        "token_exact": streams["xla"] == streams["pallas"],
        "token_agreement": round(token_agreement(streams["xla"], streams["pallas"]), 4),
        "streams": streams,
    }
    if args.tiny:
        rec["ok"] = (all(streams["xla"]) and all(streams["pallas"])
                     and rec["token_agreement"] >= MIN_TINY_AGREEMENT)
        rec["note"] = "tiny smoke: golden answers not applicable"
    else:
        rec["ok"] = answers["xla"] == answers["pallas"] == list(EXPECTED_ANSWERS)
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    rec = record(argv)
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
