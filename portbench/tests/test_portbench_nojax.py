"""The run's own look for JAX, and its refusal without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import run as run_lib, spec


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("retake_tpu_torch.fake", "jaxtyping_like", "retake_tpux"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run_lib.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "retake_tpu.ops", object())
    assert run_lib.forbidden_modules() == ["jax.numpy", "retake_tpu.ops"]


def test_the_harness_imports_no_jax():
    code = ("import sys, portbench.run, portbench.calibrate, portbench.sweep; "
            "from portbench import program; import retake_tpu_torch.runtime.serve, "
            "retake_tpu_torch.runtime.llava_engine; "
            "print(portbench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True, env=dict(os.environ, PYTHONPATH=str(spec.ROOT)))
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run_lib.main(["--workload", "qwen2-vl-7b.serve-clips", "--seed", "1",
                         "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_no_result_in_a_checkout_without_the_program(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_pycache", "_trace", "__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "qwen2-vl-7b.serve-clips", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
