"""A model family and a kernel are files found by name: the two families'
modules give the FLOP counts, trees and requests they gave before they
were modules of their own; a third family and a fifth kernel join as new
files alone, and an unknown family fails naming its file."""

import hashlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from portbench import counts, program, readers, run as run_lib, spec, traffic
from portbench.tests import tiny

SEED = 2**31 + 12345

# readers.request_flops at the cells' published widths: (frames, decode tokens) -> FLOPs
FLOPS = {
    "qwen2-vl-7b.video-qa-1024f": {(1024, 0): 1897029470674944.0,
                                   (1024, 31): 1897866647314432.0},
    "llava-video-7b.video-qa-384f": {(384, 0): 1983140153274368.0,
                                     (384, 31): 1984076767105024.0},
    "qwen2-vl-7b.serve-clips": {(16, 10): 22690623766528.0, (32, 10): 44908949389312.0,
                                (48, 10): 67659985174528.0, (64, 10): 90943731122176.0,
                                (96, 10): 139109353504768.0},
}


@pytest.mark.parametrize("name,frames,decode,want",
                         [(n, f, d, v) for n, vals in FLOPS.items()
                          for (f, d), v in vals.items()])
def test_request_flops_at_published_widths(name, frames, decode, want):
    cell = spec.cell(name)
    run = types.SimpleNamespace(family=cell["family"], config=cell["config"],
                                traffic=cell["traffic"])
    assert readers.request_flops(run, frames, decode) == want


def digest(obj) -> str:
    """sha256 over every leaf of a nested dict, keys in sorted order: its
    path, shape, dtype and bytes."""
    h = hashlib.sha256()

    def walk(prefix, x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(prefix + "/" + k, x[k])
        elif isinstance(x, torch.Tensor):
            h.update(prefix.encode())
            h.update(str(tuple(x.shape)).encode() + str(x.dtype).encode())
            h.update(x.detach().contiguous().view(torch.uint8).numpy().tobytes())
        elif isinstance(x, np.ndarray):
            h.update(prefix.encode() + str(x.dtype).encode() + str(x.shape).encode())
            h.update(np.ascontiguousarray(x).tobytes())
        else:
            h.update(prefix.encode() + repr(x).encode())

    walk("", obj)
    return h.hexdigest()


# taken from the trees and requests as weights.py and traffic.py drew them
# before the families had modules of their own
PINNED = {
    ("qwen2_vl", "tree", 0): "14a76b51cdfe2cb8017fa158391383d223695d4d807128c79fefb00162a56982",
    ("qwen2_vl", "tree", SEED): "560d6ea8a89927fdf9ba98972f4baa82df1592e951eb5e7fbc0ba1b19d9266cc",
    ("llava_video", "tree", 0): "5d02dc18610dde8499bcde267ddcf3d08ebb47922db9cdc27c655d000c575c2d",
    ("llava_video", "tree", SEED):
        "bf1dbf1421cfefe1faa91e19665c9bfec0329d3ac6f4f581f85dbbd605e8960b",
    ("qwen2_vl", "request", 0): "09af479fab719c5226603b652490434aeaf85c220fd6ebf6c86d10dfcc664c8c",
    ("qwen2_vl", "request", 3): "ad5cfe70fbcc29edeb43af96675b5966c86ae51f209079ad26badaca2cb78d8d",
    ("qwen2_vl", "request", -1):
        "dbff77500b1fddd77db1dbef04f82dc7a0ce64639a3850f9a20c2cf8110fdf8d",
    ("llava_video", "request", 0):
        "ae2af1733a59ea8ff2ed027219dc56a5df1253c367006b04e5e4b532219f4683",
    ("llava_video", "request", 3):
        "427c2140402958ac1a5df5e909f4160e0fa5754dad90b603b980f8fcaabc41c2",
    ("llava_video", "request", -1):
        "2a9d7904bf5f8f8b4b943f19c8c020a035b5af8e14a313aa0b22cb9bd9387656",
}
CONFIGS = {"qwen2_vl": tiny.qwen_config, "llava_video": tiny.llava_config}


@pytest.mark.parametrize("key", list(PINNED), ids=lambda k: f"{k[0]}-{k[1]}-{k[2]}")
def test_tiny_trees_and_requests_are_the_pinned_ones(key):
    """Request inputs (tiny 8-frame video QA at ``SEED``) by the family's
    name and by its module alike; trees at seed 0 and ``SEED``."""
    fam, what, n = key
    mod = spec.family(fam)
    if what == "tree":
        assert digest(mod.tree(CONFIGS[fam](), n, "cpu")) == PINNED[key]
        return
    for family in (fam, mod):
        req = traffic.request(family, CONFIGS[fam](), tiny.video_qa(8), SEED, n, 8, "cpu")
        assert digest(req) == PINNED[key]


def test_families_and_kernels_import_no_jax():
    """Every cell's family module and every kernel module, with the entry
    points ``KernelCalls`` wraps imported, leave no JAX module loaded."""
    code = ("from portbench import program, run, spec\n"
            "for w in spec.benchmark()['workloads']:\n"
            "    spec.cell(w['name'])\n"
            "with program.KernelCalls(spec.kernels()).recording():\n"
            "    pass\n"
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True, env=dict(os.environ, PYTHONPATH=str(spec.ROOT)))
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("k", sorted(spec.kernels()))
def test_each_kernel_names_an_entry_point_of_the_port(k):
    kmod = spec.kernels()[k]
    path, name = kmod.ENTRY
    assert callable(getattr(importlib.import_module(path), name))
    assert kmod.DEVICE_NAMES and callable(kmod.record) and callable(kmod.count)


# ---------- new families and kernels as files alone ----------


def _copy(tmp_path):
    """A copy of the benchmark, and the bytes of every file it had."""
    root = tmp_path / "repo"
    shutil.copytree(spec.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("_pycache", "_trace", "__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root, {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}


def _unchanged(before):
    for path, data in before.items():  # no file the benchmark had was edited...
        if path.name != "BENCHMARK.json":  # ...but the entries of the benchmark file
            assert path.read_bytes() == data, path


MIRROR = '''"""A third family: Qwen2-VL's engine and reference under another name,
each hook counted."""

from pathlib import Path

from portbench import spec

BASE = spec.family("qwen2_vl", Path(__file__).resolve().parents[2])
CALLED = []


def _counted(name):
    def hook(*args, **kw):
        CALLED.append(name)
        return getattr(BASE, name)(*args, **kw)

    return hook


tree, build, layout, request, reference_logits, request_flops = (
    _counted(n) for n in ("tree", "build", "layout", "request", "reference_logits",
                          "request_flops"))
'''


def _with_family(tmp_path, family="mirror_vl", source=MIRROR):
    """The copy with a cell of a configuration of ``family``, whose module
    is ``source`` (None: no module), as new files and entries alone: a
    tiny Qwen2-VL configuration, a 16-frame closed-loop mix, its limit."""
    root, before = _copy(tmp_path)
    pb = root / "portbench"
    if source is not None:
        (pb / "families" / f"{family}.py").write_text(source)
    conf = dict(tiny.qwen_config(), family=family, name="mirror-vl")
    (pb / "configs" / "mirror-vl.json").write_text(json.dumps(conf))
    (pb / "traffic" / "video-qa-tiny.json").write_text(json.dumps(tiny.video_qa(16)))
    name = "mirror-vl.video-qa-tiny"
    limit = spec.cell("qwen2-vl-7b.video-qa-1024f")["limits"]["logit_err"]["limit"]
    (pb / "limits" / f"{name}.json").write_text(json.dumps({"logit_err": {"limit": limit}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="mirror-vl", source=conf["source"], reduced=[],
                                 file="portbench/configs/mirror-vl.json", why="x"))
    bench["workloads"].append(dict(name=name, config="mirror-vl", traffic="video-qa-tiny",
                                   chips=1, why="x"))
    for m in bench["end_to_end"]:
        if m["name"] in ("ttft_s", "tpot_ms"):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, name, before


def test_a_new_family_is_new_files_only(tmp_path):
    """A family module, a configuration, a mix, a limit and the entries:
    the harness's own run of the cell serves it through the new module and
    comes out correct."""
    root, name, before = _with_family(tmp_path)
    cell = spec.cell(name, root=root)
    fam = cell["family"]
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        torch.manual_seed(0)
        out = run_lib.run_cell(cell, SEED, 0.0, False, "cpu")
    finally:
        torch.set_num_threads(n)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert {m for m in out["metrics"]} == {"ttft_s", "tpot_ms", "setup_s"}
    assert {"tree", "build", "request", "reference_logits"} <= set(fam.CALLED)
    run = types.SimpleNamespace(family=fam, config=cell["config"], traffic=cell["traffic"])
    qwen = types.SimpleNamespace(family="qwen2_vl", config=cell["config"],
                                 traffic=cell["traffic"])
    assert readers.request_flops(run, 16, 5) == readers.request_flops(qwen, 16, 5)
    ids = traffic.layout(fam, cell["config"], cell["traffic"], 16)[0]
    assert np.array_equal(ids, traffic.layout("qwen2_vl", cell["config"], cell["traffic"], 16)[0])
    assert {"layout", "request_flops"} <= set(fam.CALLED)
    _unchanged(before)


def test_an_unknown_family_names_its_file(tmp_path):
    root, name, _ = _with_family(tmp_path, family="no_such_family", source=None)
    with pytest.raises(SystemExit, match="families/no_such_family.py"):
        spec.cell(name, root=root)


FAKE_OPS = '''"""A kernel entry point of a program (the test's stand-in)."""


def fused(x, n, scale=1.0):
    return x * scale
'''

FIVE = '''"""A fifth kernel: ``fused`` over ``m`` rows of ``n``."""

from portbench import program

ENTRY = ("pb_fake_ops", "fused")
DEVICE_NAMES = ("fused_kernel",)


def record(x, n, scale=1.0):
    return dict(m=x.shape[0], n=program.device_scalar(n))


def count(c):
    return {"flops": 2.0 * c["m"] * c["n"], "bytes": 4.0 * c["m"] * c["n"]}
'''

GONE = '''ENTRY = ("pb_no_such_ops", "fused")
DEVICE_NAMES = ("gone_kernel",)


def record(*args, **kw):
    raise AssertionError("a gone entry point is not wrapped")


def count(c):
    raise AssertionError("a gone entry point has no calls")
'''


def test_a_new_kernel_is_new_files_only(tmp_path, monkeypatch):
    """A kernel module and its roofline reader alone: ``KernelCalls``
    wraps the entry point it names, ``roofline`` reads its calls against
    its device names; an entry point that is gone is skipped."""
    root, before = _copy(tmp_path)
    pb = root / "portbench"
    (pb / "kernels" / "k5.py").write_text(FIVE)
    (pb / "kernels" / "k6.py").write_text(GONE)
    (pb / "metrics" / "k5_roofline.py").write_text(
        "from portbench.readers import roofline\n\n\ndef read(run):\n"
        "    return roofline(run, 'k5', 'prefill')\n")
    (tmp_path / "pb_fake_ops.py").write_text(FAKE_OPS)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, "pb_fake_ops", raising=False)
    import pb_fake_ops

    mods = spec.kernels(root)
    assert set(mods) == {"k1", "k2", "k3", "k4", "k5", "k6"}
    plain = pb_fake_ops.fused
    calls = program.KernelCalls({k: mods[k] for k in ("k5", "k6")})
    with calls.recording():
        assert pb_fake_ops.fused is not plain
        pb_fake_ops.fused(torch.ones(3, 2), torch.tensor([7, 9]), scale=2.0)
        pb_fake_ops.fused(torch.ones(5, 2), 11)
    assert pb_fake_ops.fused is plain
    got = calls.resolved()
    assert got == {"k5": [dict(m=3, n=7), dict(m=5, n=11)], "k6": []}

    seen = []

    def device_s(names):
        seen.append(names)
        return 1e-9

    run = types.SimpleNamespace(kernels=got, kernel_modules=mods,
                                profiles={"prefill": types.SimpleNamespace(device_s=device_s)})
    bound = counts.bound_seconds({"flops": 42.0, "bytes": 84.0}) + counts.bound_seconds(
        {"flops": 110.0, "bytes": 220.0})
    assert spec.metric_reader("k5_roofline", root=root)(run) == pytest.approx(100 * bound / 1e-9)
    assert seen == [("fused_kernel",)]
    assert readers.roofline(run, "k6", "prefill") is None
    _unchanged(before)


# ---------- the counts' head size ----------

WIDE = dict(hidden_size=2048, intermediate_size=768, num_hidden_layers=3, num_attention_heads=32,
            num_key_value_heads=4, vocab_size=1000)


def test_counts_follow_head_dim():
    """A text config whose ``head_dim`` (128) is not ``hidden_size //
    heads`` (64): attention and scores at twice the work, q / o at the
    heads' width; with no key, today's counts."""
    d, m, l, h, kv = 2048, 768, 3, 32, 4
    plain, wide = WIDE, dict(WIDE, head_dim=128)
    assert counts.attention_flops(wide, 100, 50) == 2 * counts.attention_flops(plain, 100, 50)
    assert counts.score_flops(wide, 50) == 2 * counts.score_flops(plain, 50)
    assert counts.text_linear_flops(wide, 7) == 2.0 * 7 * l * (
        d * h * 128 + 2 * d * kv * 128 + h * 128 * d + 3 * d * m)
    assert counts.text_linear_flops(plain, 7) == 2.0 * 7 * l * (
        d * d + 2 * d * kv * 64 + d * d + 3 * d * m)
    assert counts.attention_flops(plain, 100, 50) == 4.0 * h * 64 * (
        50 * 100 + 50 * 51 / 2) * l
    same = dict(WIDE, head_dim=64)
    steps = [dict(valid=40, cache_len=0, compress=True, keep=30),
             dict(valid=40, cache_len=30, compress=False, keep=40)]
    assert counts.request_flops(1.0, same, steps, 3) == counts.request_flops(1.0, plain, steps, 3)
