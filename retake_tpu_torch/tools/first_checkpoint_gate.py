"""Acceptance gate for a real checkpoint: one command, one verdict (port of
``tools/first_checkpoint_gate.py``).

What random weights cannot show becomes checkable once weights exist:

  1. demo golden answers: the three multiple-choice questions of the demo
     answered A, B, C on the reference's bundled video (``demo``);
  2. quantization agreement: greedy-token agreement of int8 / w8a8 /
     int8-KV / w8a8 + int8-KV with bf16 (``tools/quant_ablation.py``),
     each >= ``--quant_threshold``;
  3. spec-decode parity: the demo with prompt-lookup speculation gives the
     same answers (``demo --spec``);
  4. prefix-reuse parity: the demo recomputing everything per question
     gives the same tokens as the default run, which reuses the video
     prefill (``demo --no-reuse``): token-exact, the reuse forks a
     byte-identical cache;
  5. the HTTP golden question (``tools/gate_http_stage.py``);
  6. serving decode parity, plain arm vs K4 (``tools/gate_serve_decode_stage.py``);
  7. a Video-MME slice: the first ``--videomme_samples`` samples through
     the eval runner (``eval/infer_eval.py``), its accuracy reported.

Each stage runs as its own process (``python -m retake_tpu_torch.<module>``
with ``--device`` passed through: a fresh process owns the card's memory).
``report(argv, run=...)`` takes another runner: ``in_process`` calls each
module's ``record`` (or ``main``) in this process. Prints one JSON line
``{"demo": ..., "quant": ..., "spec_parity": ..., "prefix_parity": ...,
"http_golden": ..., "serve_decode_parity": ..., "videomme_slice": ...,
"pass": bool}`` (each stage's record with its ``seconds``) and exits 0
only on ``pass``.

Beyond the JAX tool's flags: ``--device``, ``--video_frame_extraction_fps``
(a frame directory as ``--video``, and the Video-MME frame directories) and
``--max_new_tokens`` (every stage's token budget; default: each stage's own).

Usage:
  python3 -m retake_tpu_torch.tools.first_checkpoint_gate \\
      --hf_path /ckpts/Qwen2-VL-7B-Instruct --video misc/demo.mp4 \\
      --videomme_anno dataset/videomme/videomme.json --videomme_samples 16
  python3 -m retake_tpu_torch.tools.first_checkpoint_gate --tiny-smoke --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STAGES = ["demo", "quant", "videomme", "spec", "http", "prefix", "serve_decode"]
# a runner: (module under retake_tpu_torch, argv, timeout_s=) -> (exit code,
# its JSON record or None, the end of its stderr or traceback)
Runner = Callable[..., Tuple[int, Optional[dict], str]]


def _last_json(lines):
    for ln in reversed(lines):
        try:
            return json.loads(ln)
        except json.JSONDecodeError:
            continue
    return None


def in_subprocess(module: str, argv: List[str], timeout_s: float = 3600) -> tuple:
    out = subprocess.run([sys.executable, "-m", f"retake_tpu_torch.{module}"] + argv,
                         capture_output=True, text=True, timeout=timeout_s, cwd=REPO)
    lines = [ln for ln in out.stdout.strip().splitlines() if ln.strip()]
    return out.returncode, _last_json(lines), out.stderr[-2000:]


def in_process(module: str, argv: List[str], timeout_s: float = 0) -> tuple:
    """``module.record(argv)`` in this process (``module.main(argv)`` for a
    module without one, its stdout kept back); an exception is exit code 1."""
    mod = importlib.import_module(f"retake_tpu_torch.{module}")
    try:
        if hasattr(mod, "record"):
            return 0, mod.record(argv), ""
        with contextlib.redirect_stdout(io.StringIO()):
            return mod.main(argv), None, ""
    except (Exception, SystemExit):
        return 1, None, traceback.format_exc()[-2000:]


def _error(err: str) -> dict:
    return {"ok": False, "error": err[-300:]}


def _model_args(args) -> List[str]:
    out = ["--tiny"] if args.tiny_smoke else ["--hf_path", args.hf_path]
    if args.video:
        out += ["--video", args.video,
                "--video_frame_extraction_fps", str(args.video_frame_extraction_fps)]
    if args.max_new_tokens:
        out += ["--max_new_tokens", str(args.max_new_tokens)]
    return out + ["--device", args.device]


def _demo(args, run: Runner, *extra) -> tuple:
    return run("demo", ["--config", args.config, "--json", *extra] + _model_args(args))


def stage_demo(args, run: Runner) -> dict:
    rc, rec, err = _demo(args, run)
    if rc != 0 or rec is None:
        return _error(err)
    if args.tiny_smoke:
        # random weights cannot hit the goldens: three non-empty streams
        rec["ok"] = len(rec.get("tokens") or []) == 3 and all(rec["tokens"])
        rec["note"] = "tiny smoke: golden answers not applicable"
        return rec
    rec["ok"] = bool(rec.get("golden_pass"))
    if not args.video:
        rec["note"] = "no --video: answers are not the bundled-video goldens"
        rec["ok"] = False
    return rec


def stage_quant(args, run: Runner) -> dict:
    argv = ["--hf_path", args.hf_path, "--frames", str(args.quant_frames), "--json",
            "--device", args.device]
    if args.max_new_tokens:
        argv += ["--max-new-tokens", str(args.max_new_tokens)]
    rc, rec, err = run("tools.quant_ablation", argv)
    if rc != 0 or rec is None:
        return _error(err)
    agr = rec.get("agreement_vs_bf16", {})
    rec["threshold"] = args.quant_threshold
    rec["ok"] = bool(agr) and all(v >= args.quant_threshold for v in agr.values())
    return rec


def _baseline(args, run: Runner, baseline: Optional[dict]) -> tuple:
    """The default demo run's record (the demo stage's, when it gave tokens)."""
    if baseline is not None and baseline.get("tokens"):
        return baseline, ""
    rc, rec, err = _demo(args, run)
    return (rec, "") if rc == 0 and rec is not None else (None, err)


def prefix_lens(base: List[List[int]], other: List[List[int]]) -> List[int]:
    """For each stream pair, the length of the common prefix."""
    return [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            for a, b in zip(base, other)]


def tokens_exact(base: List[List[int]], other: List[List[int]]) -> bool:
    return len(base) == len(other) > 0 and all(a == b for a, b in zip(base, other))


def stage_spec(args, run: Runner, baseline: Optional[dict] = None) -> dict:
    """Spec-decode parity: the demo with and without prompt-lookup
    speculation. Verification compares against the argmax, so with real
    weights the answers must agree; the tiny random model may flip a
    near-tie argmax after a long shared prefix, so there each stream must
    share at least 8 tokens."""
    baseline, err = _baseline(args, run, baseline)
    if baseline is None:
        return _error(err)
    rc, rec, err = _demo(args, run, "--spec")
    if rc != 0 or rec is None:
        return _error(err)
    base_toks, spec_toks = baseline.get("tokens") or [], rec.get("tokens") or []
    prefixes = prefix_lens(base_toks, spec_toks)
    out = {
        "answers_spec": rec.get("answers"),
        "answers_base": baseline.get("answers"),
        "token_exact": tokens_exact(base_toks, spec_toks),
        "agree_prefix_lens": prefixes,
    }
    if args.tiny_smoke:
        out["ok"] = bool(spec_toks) and all(p >= 8 for p in prefixes)
    else:
        out["ok"] = rec.get("answers") == baseline.get("answers") and bool(spec_toks)
    return out


def stage_prefix(args, run: Runner, baseline: Optional[dict] = None) -> dict:
    """Prefix-reuse parity: the default demo reuses the question-independent
    prefill across its three questions; ``--no-reuse`` recomputes it for
    each. Reuse forks a byte-identical cache, so the streams must be
    token-exact."""
    baseline, err = _baseline(args, run, baseline)
    if baseline is None:
        return _error(err)
    rc, rec, err = _demo(args, run, "--no-reuse")
    if rc != 0 or rec is None:
        return _error(err)
    exact = tokens_exact(baseline.get("tokens") or [], rec.get("tokens") or [])
    return {"answers_reuse": baseline.get("answers"), "answers_inline": rec.get("answers"),
            "token_exact": exact, "ok": exact}


def _stage_tool(module: str, args, run: Runner) -> dict:
    rc, rec, err = run(module, ["--config", args.config] + _model_args(args))
    if rc != 0 and not rec:
        return _error(err)
    rec["ok"] = bool(rec.get("ok"))
    return rec


def stage_http(args, run: Runner) -> dict:
    """One golden question through the online serving stack (HTTP over a
    real socket, continuous batching underneath)."""
    return _stage_tool("tools.gate_http_stage", args, run)


def stage_serve_decode(args, run: Runner) -> dict:
    """The three demo questions through ContinuousServer under the plain
    decode arm and K4: the same golden answers."""
    return _stage_tool("tools.gate_serve_decode_stage", args, run)


def stage_videomme(args, run: Runner) -> dict:
    if not args.videomme_anno:
        return {"ok": False, "error": "no --videomme_anno given"}
    import yaml

    with open(args.videomme_anno) as f:
        annos = json.load(f)
    tmpdir = tempfile.mkdtemp(prefix="ckpt_gate_")
    sliced = os.path.join(tmpdir, "videomme_slice.json")
    with open(sliced, "w") as f:
        json.dump(annos[: args.videomme_samples], f)
    with open(os.path.join(REPO, args.videomme_config)) as f:
        cfg = yaml.safe_load(f)
    cfg["anno_file"] = sliced
    cfg["output_dir"] = os.path.join(tmpdir, "results")
    if args.max_new_tokens:
        cfg["max_new_tokens"] = args.max_new_tokens
    cfg_path = os.path.join(tmpdir, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    rc, _, err = run("eval.infer_eval", [
        "--hf_path", args.hf_path, "--config_path", cfg_path,
        "--video_frame_extraction_fps", str(args.video_frame_extraction_fps),
        "--device", args.device], timeout_s=args.videomme_samples * 600)
    if rc != 0:
        return _error(err)
    import pandas as pd

    df = pd.read_csv(os.path.join(cfg["output_dir"], "eval_results.csv"), index_col=0)
    acc = float(df.iloc[-1, 0])  # the "overall" row
    return {"ok": True, "samples": args.videomme_samples, "slice_accuracy": round(acc, 4),
            "results_dir": cfg["output_dir"]}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--hf_path", default=None, help="checkpoint dir (required unless --tiny-smoke)")
    p.add_argument("--config", default="configs/retake_demo.yaml")
    p.add_argument("--video", default=None,
                   help="the reference's bundled demo video (misc/demo.mp4), or a frame dir")
    p.add_argument("--video_frame_extraction_fps", type=int, default=25,
                   help="the fps the frame directories (--video, Video-MME) were extracted at")
    p.add_argument("--videomme_anno", default=None)
    p.add_argument("--videomme_config", default="configs/qwen2_vl/retake_qwen2-vl_videomme.yaml")
    p.add_argument("--videomme_samples", type=int, default=16)
    p.add_argument("--quant_frames", type=int, default=256)
    p.add_argument("--quant_threshold", type=float, default=0.90,
                   help="min greedy-token agreement vs bf16 for each quantized mode")
    p.add_argument("--max_new_tokens", type=int, default=None,
                   help="every stage's token budget (default: each stage's own)")
    p.add_argument("--skip", nargs="*", default=[], choices=STAGES)
    p.add_argument("--tiny-smoke", action="store_true",
                   help="dry run of the gate itself on the tiny random model (no checkpoint "
                        "needed); skips quant and videomme, which need real weights and data")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.tiny_smoke:
        args.skip = sorted(set(args.skip) | {"quant", "videomme"})
    elif not args.hf_path:
        p.error("--hf_path is required unless --tiny-smoke")
    for name in ("hf_path", "video", "videomme_anno"):
        if getattr(args, name):  # the stages run from the repository's root
            setattr(args, name, os.path.abspath(getattr(args, name)))
    for name in ("config", "videomme_config"):  # the caller's, else the repository's
        path = getattr(args, name)
        setattr(args, name, os.path.abspath(path) if os.path.exists(path)
                else os.path.join(REPO, path))
    return args


def report(argv: Optional[List[str]] = None, run: Runner = in_subprocess) -> dict:
    """Every stage not skipped, through ``run``; the gate's JSON record."""
    args = parse_args(argv)
    out = {}

    def stage(key, fn, *a, **kw):
        t0 = time.perf_counter()
        out[key] = fn(args, run, *a, **kw)
        out[key]["seconds"] = time.perf_counter() - t0  # the stage's wall, processes included
        return out[key]

    demo_rec = None
    if "demo" not in args.skip:
        demo_rec = stage("demo", stage_demo)
    if "quant" not in args.skip:
        stage("quant", stage_quant)
    if "spec" not in args.skip:
        stage("spec_parity", stage_spec, baseline=demo_rec)
    if "prefix" not in args.skip:
        stage("prefix_parity", stage_prefix, baseline=demo_rec)
    if "http" not in args.skip:
        stage("http_golden", stage_http)
    if "serve_decode" not in args.skip:
        stage("serve_decode_parity", stage_serve_decode)
    if "videomme" not in args.skip:
        stage("videomme_slice", stage_videomme)
    out["pass"] = all(v.get("ok") for v in out.values())
    return out


def main(argv: Optional[List[str]] = None) -> int:
    rec = report(argv)
    print(json.dumps(rec))
    return 0 if rec["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
