"""The port's first-checkpoint gate and its tools
(``retake_tpu_torch/tools/``) against the JAX tools on the CPU, fp32.

The JAX tools (``tools/*.py``, the root ``demo.py``) are loaded by file path
and run in this process. Both sides get the same tiny model: the JAX tools'
``TINY_TEST_CONFIG`` and ``_StubTokenizer`` are patched to the port demo's
``tiny_config()`` and ``StubTokenizer`` (special ids inside the 512-token
vocabulary), and the port's ``init_params`` returns the JAX init of that
config (seed 0), bridged. Tolerances: token streams are compared exactly
(the JAX and port engines agree token for token on these configs:
tests/test_torch_serve.py, test_torch_quant.py); the port's K4 arm on the
CPU (its plain twin) is held to the JAX stage's tiny bar, aggregate
agreement >= 0.7 with the plain arm's streams.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import py_compile
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import retake_tpu.models.qwen2_vl.config as jconfig
import retake_tpu.runtime.engine as jengine
import retake_tpu.runtime.serve as jserve
from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu_torch import demo as tdemo
from retake_tpu_torch.eval.synthetic import save_offline_tokenizer, write_frames, write_videomme
from retake_tpu_torch.models.qwen2_vl import params as tparams
from retake_tpu_torch.models.qwen2_vl.config import qwen2_vl_2b
from retake_tpu_torch.tools import (bench_model, cal_ttft, first_checkpoint_gate,
                                    gate_http_stage, gate_serve_decode_stage, profile_trace,
                                    quant_ablation)
from torch_parity import port_cfg, port_params, tiny_cfg, video_request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_MODULES = ("bench_model", "cal_ttft", "first_checkpoint_gate", "gate_http_stage",
               "gate_serve_decode_stage", "profile_trace", "quant_ablation")
MIN_TINY_AGREEMENT = 0.7  # the JAX serving stage's tiny bar


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one intra-op thread, as in
    tests/test_torch_parallel.py: beside JAX's thread pool and the other
    test workers, torch's own pool oversubscribes the cores (these tests
    ran ~10x slower in the parallel suite without it); restored after the
    module."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tool(name: str):
    """``tools/<name>.py`` (or the root ``demo.py``) as a fresh module."""
    path = os.path.join(REPO, "demo.py" if name == "demo" else os.path.join("tools", name + ".py"))
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_main(mod, argv, monkeypatch) -> dict:
    """``mod.main()`` with ``argv``: its last stdout line as JSON."""
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tiny():
    """The port demo's tiny geometry as a JAX config, and its JAX init."""
    d = dataclasses.asdict(tdemo.tiny_config())
    cfg = jconfig.Qwen2VLConfig(**{**d, "vision": jconfig.Qwen2VisionConfig(**d["vision"])})
    return cfg, jparams.init_params(cfg, seed=0, dtype=jnp.float32)


@pytest.fixture
def same_tiny(tiny, monkeypatch):
    """Both packages' ``--tiny`` modes on one model and one stub tokenizer."""
    cfg, jp = tiny
    jax_tool("demo")  # puts the repository's root on sys.path for `import demo`
    import demo as jdemo

    monkeypatch.setattr(jconfig, "TINY_TEST_CONFIG", cfg)
    monkeypatch.setattr(jdemo, "_StubTokenizer", lambda: tdemo.StubTokenizer(cfg.vocab_size))

    def init_params(c, **kw):
        assert c == tdemo.tiny_config() and kw.get("seed", 0) == 0
        return port_params(jp)

    monkeypatch.setattr(tparams, "init_params", init_params)


@pytest.fixture(scope="module")
def demo_yaml(tmp_path_factory):
    """configs/retake_demo.yaml with a 16-token budget."""
    with open(os.path.join(REPO, "configs", "retake_demo.yaml")) as f:
        text = f.read()
    path = tmp_path_factory.mktemp("cfg") / "demo16.yaml"
    path.write_text(text + "\nmax_new_tokens: 16\n")
    return str(path)


def test_demo_spec_tokens_match_the_jax_demo(same_tiny, demo_yaml, monkeypatch):
    """``demo --tiny --json --spec``: the JAX demo's streams exactly, and the
    port's spec streams equal its own greedy ones."""
    want = run_jax_main(jax_tool("demo"), ["--tiny", "--json", "--spec", "--config", demo_yaml],
                        monkeypatch)
    argv = ["--tiny", "--json", "--config", demo_yaml, "--device", "cpu"]
    got = tdemo.record(argv + ["--spec"])
    assert got["tokens"] == want["tokens"] and got["answers"] == want["answers"]
    assert all(len(t) == 16 for t in got["tokens"])
    assert tdemo.record(argv)["tokens"] == got["tokens"]


def test_serve_decode_stage_matches_the_jax_stage(same_tiny, monkeypatch):
    """``gate_serve_decode_stage --tiny``: the port's "xla" streams equal the
    JAX stage's "xla" streams; its "pallas" arm (K4's plain twin here)
    agrees >= 0.7 with them; the record's keys and ``ok`` rule."""
    streams = []
    run = jserve.ContinuousServer.run

    def spy(self, requests, *a, **kw):
        results = run(self, requests, *a, **kw)
        streams.append([[int(t) for t in r.tokens] for r in results])
        return results

    monkeypatch.setattr(jserve.ContinuousServer, "run", spy)
    want = run_jax_main(jax_tool("gate_serve_decode_stage"), ["--tiny"], monkeypatch)
    got = gate_serve_decode_stage.record(["--tiny", "--device", "cpu"])
    assert want["ok"] and got["ok"]
    assert got["streams"]["xla"] == streams[0]
    assert all(len(s) == 8 for s in got["streams"]["xla"])
    agree = gate_serve_decode_stage.token_agreement(got["streams"]["pallas"], streams[0])
    assert agree >= MIN_TINY_AGREEMENT
    assert set(want) <= set(got)


def test_quant_ablation_matches_the_jax_tool(monkeypatch):
    """Each of the five modes on one tiny request: the JAX tool's tokens and
    ``agreement_vs_bf16`` exactly (its ``bench`` model and request patched
    to the tiny ones). At grid_t = 2 (an 8-token video) the JAX tool's
    w8a8 + int8-KV mode gives other tokens from its first one: there the
    JAX package's own "xla" and "flash" arms and every port arm agree with
    each other, and only the JAX int8 prefill kernel in interpret mode
    differs, so the request here is grid_t = 4, where all agree."""
    cfg = tiny_cfg()
    jp = jparams.init_params(cfg, seed=0, dtype=jnp.float32)
    ids, patches, grid = video_request(cfg, np.random.default_rng(0), grid_t=4)
    jq = jax_tool("quant_ablation")
    import bench

    monkeypatch.setattr(bench, "build_model", lambda: (cfg, jp))
    monkeypatch.setattr(bench, "build_request", lambda c, num_frames: (ids, patches, grid))
    monkeypatch.setattr(bench, "_wait_for_hbm", lambda *a: None)
    tokens = []
    generate = jengine.Qwen2VLEngine.generate

    def spy(self, *a, **kw):
        r = generate(self, *a, **kw)
        tokens.append([int(t) for t in r.tokens])
        return r

    monkeypatch.setattr(jengine.Qwen2VLEngine, "generate", spy)
    want = run_jax_main(jq, ["--random-weights", "--max-new-tokens", "8", "--json"], monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()):
        got = quant_ablation.run_modes(port_cfg(cfg), port_params(jp), ids, patches, grid, 8, "cpu")
    assert [name for name, _ in quant_ablation.MODES] == [name for name, _ in jq.MODES]
    assert [got["tokens"][name] for name, _ in quant_ablation.MODES] == tokens
    assert got["agreement_vs_bf16"] == want["agreement_vs_bf16"]
    assert len(got["agreement_vs_bf16"]) == 4


def test_http_stage_round_trips(same_tiny, demo_yaml):
    """``gate_http_stage --tiny``: HTTP 200, tokens, ``/metrics`` counting
    the request."""
    rec = gate_http_stage.record(["--tiny", "--device", "cpu", "--config", demo_yaml])
    assert rec["ok"] and rec["status"] == 200 and rec["served_total"] == 1
    assert rec["n_tokens"] == 16 and rec["ttft_s"] >= 0


def test_cal_ttft_prints_both_figures(capsys):
    assert cal_ttft.main(["--tiny", "--device", "cpu", "--runs", "2", "--tpot_tokens", "4",
                          "--frames", "4"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert any(line.startswith("TTFT @ 4 frames:") for line in out)
    assert any(line.startswith("TPOT:") for line in out)
    assert len(rec["ttft_runs_s"]) == 2 and rec["tpot_tokens"] == 4
    assert math.isfinite(rec["ttft_s"]) and math.isfinite(rec["tpot_ms"])


@pytest.mark.parametrize("frames", [2, 4, 64])
def test_build_request_gives_the_bench_ids_and_grid(frames):
    """The jax-free bench request: ``bench.build_request``'s ids and grid;
    its patches drawn on the device, bf16, of the same shape."""
    jax_tool("quant_ablation")  # the repository's root on sys.path
    import bench

    jcfg = jconfig.Qwen2VLConfig(vocab_size=151936, hidden_size=1536, intermediate_size=8960,
                                 num_hidden_layers=28, num_attention_heads=12,
                                 num_key_value_heads=2, tie_word_embeddings=True,
                                 vision=jconfig.Qwen2VisionConfig(hidden_size=1536))
    want_ids, want_patches, want_grid = bench.build_request(jcfg, num_frames=frames)
    ids, patches, grid = bench_model.build_request(qwen2_vl_2b(), frames, "cpu", 0)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(grid, want_grid)
    assert tuple(patches.shape) == tuple(want_patches.shape) and str(patches.dtype) == "torch.bfloat16"


def test_profile_trace_writes_a_trace(tmp_path, capsys):
    rec = profile_trace.record(["--tiny", "--device", "cpu", "--frames", "4",
                                "--max_new_tokens", "2", "--out", str(tmp_path)])
    with open(rec["trace"]) as f:
        trace = json.load(f)
    assert trace["traceEvents"] and rec["wall_s"] > 0 and rec["busy_s"] == 0


@pytest.mark.parametrize("module", ["demo", "tools.cal_ttft", "tools.gate_http_stage",
                                    "tools.gate_serve_decode_stage", "tools.profile_trace",
                                    "tools.quant_ablation"])
def test_entry_points_default_to_the_card(module):
    """Every entry point's default device is ``cuda``: without a card it
    raises instead of running on the CPU."""
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    mod = importlib.import_module(f"retake_tpu_torch.{module}")
    argv = ["--tiny"] if module != "tools.quant_ablation" else ["--random-weights"]
    with pytest.raises(RuntimeError, match="cuda.is_available"):
        mod.record(argv)


def test_gate_reports_a_failed_stage_and_fails(capsys):
    """A stage that raises is an ``error`` in its record and fails the gate:
    here every stage asks for the card this machine lacks."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rec = first_checkpoint_gate.report(["--tiny-smoke", "--skip", "spec", "prefix"],
                                       run=first_checkpoint_gate.in_process)
    assert rec["pass"] is False
    assert set(rec) == {"demo", "http_golden", "serve_decode_parity", "pass"}
    assert all("cuda.is_available" in v["error"] for k, v in rec.items() if k != "pass")


@pytest.fixture(scope="module")
def hf_tiny(tmp_path_factory):
    """A tiny Qwen2-VL with Qwen2-VL's vocabulary and special ids (what
    ``from_pretrained``'s processor assumes) saved as an HF checkpoint
    (``chip_smoke.py``'s writer) with an offline tokenizer; a 12-frame JPEG
    directory and a 2-sample Video-MME benchmark."""
    import torch

    import chip_smoke
    from retake_tpu_torch.models.qwen2_vl.config import Qwen2VisionConfig, Qwen2VLConfig
    from retake_tpu_torch.utils import safetensors_io

    cfg = Qwen2VLConfig(vocab_size=151936, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                        mrope_section=(4, 2, 2), tie_word_embeddings=False,
                        vision=Qwen2VisionConfig(depth=2, embed_dim=32, hidden_size=64,
                                                 mlp_ratio=2, num_heads=2))
    params = tparams.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    root = tmp_path_factory.mktemp("gate_hf")
    path = root / "ckpt"
    path.mkdir()
    safetensors_io.save_file(chip_smoke.hf_tensors_of(cfg, params),
                             str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(chip_smoke.hf_config_of(cfg)))
    save_offline_tokenizer(str(path))
    frames = root / "frames"
    frames.mkdir()
    write_frames(str(frames), 12, 84, 56, seed=1)
    anno = write_videomme(str(root / "videomme"), [2], 12, 84, 56)
    return str(path), str(frames), anno


def test_gate_stages_on_a_saved_checkpoint(hf_tiny, capsys):
    """The gate in this process on a saved tiny HF checkpoint, the path a
    real checkpoint takes (bf16 on the CPU; the quant and serving-decode
    stages, slow there, are held to the JAX tools above): no stage errs,
    prefix reuse is token-exact, the Video-MME slice is scored from
    ``eval_results.csv``; random weights miss the goldens, so the verdict is
    false."""
    hf_path, frames, anno = hf_tiny
    rec = first_checkpoint_gate.report(
        ["--hf_path", hf_path, "--video", frames, "--video_frame_extraction_fps", "2",
         "--videomme_anno", anno, "--videomme_samples", "2", "--max_new_tokens", "4",
         "--skip", "quant", "serve_decode", "--device", "cpu"], run=first_checkpoint_gate.in_process)
    stages = ("demo", "spec_parity", "prefix_parity", "http_golden", "videomme_slice")
    assert set(rec) == set(stages) | {"pass"}
    assert not [k for k in stages if "error" in rec[k]], rec
    assert rec["prefix_parity"]["token_exact"] and len(rec["spec_parity"]["agree_prefix_lens"]) == 3
    assert rec["http_golden"]["status"] == 200 and rec["http_golden"]["n_tokens"] == 4
    assert rec["videomme_slice"]["ok"] and 0 <= rec["videomme_slice"]["slice_accuracy"] <= 1
    assert all(len(t) == 4 for t in rec["demo"]["tokens"])
    assert rec["pass"] is False  # random weights: the goldens wait for real ones


@pytest.mark.slow
def test_gate_tiny_smoke_as_a_process():
    """``python -m retake_tpu_torch.tools.first_checkpoint_gate --tiny-smoke
    --device cpu`` (16 tokens an answer), every stage a process of its own:
    the assertions of tests/test_gate.py. Slow, as its JAX counterpart is
    (~26 s on one idle host: six processes, each importing torch); the
    tests above drive each stage in this process."""
    out = subprocess.run(
        [sys.executable, "-m", "retake_tpu_torch.tools.first_checkpoint_gate", "--tiny-smoke",
         "--device", "cpu", "--max_new_tokens", "16"],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["pass"] is True
    assert rec["demo"]["ok"] and len(rec["demo"]["tokens"]) == 3
    assert rec["spec_parity"]["ok"]
    assert rec["spec_parity"]["agree_prefix_lens"]
    assert rec["prefix_parity"]["ok"]
    assert rec["prefix_parity"]["token_exact"]
    assert rec["http_golden"]["ok"] and rec["http_golden"]["n_tokens"] > 0
    assert rec["serve_decode_parity"]["ok"]
    assert rec["serve_decode_parity"]["token_agreement"] >= 0.7


@pytest.mark.parametrize("name", NEW_MODULES)
def test_new_modules_compile(name):
    py_compile.compile(os.path.join(REPO, "retake_tpu_torch", "tools", name + ".py"), doraise=True)
