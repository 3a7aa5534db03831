"""BENCHMARK.json against the contract's shape, every name resolving to its
files, and a new cell, configuration, mix and metric added as new files
and entries alone."""

import json
import re
import shutil

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in layers
        for w in m["workloads"]:  # the cells it lists report the metric it moves
            assert spec.reports(layers[m["moves"]], w)


def test_every_cell_resolves():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["limits"]["logit_err"]["limit"] > 0
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_config_files_keep_published_widths(w):
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert conf["reduced"] == []
    with open(spec.ROOT / conf["file"]) as f:
        config = json.load(f)
    assert config["source"] == conf["source"] and config["reduced"] == []


def test_a_new_cell_is_new_files_only(tmp_path):
    """Copy the benchmark, add a cell with its own configuration, mix,
    limit and metric as new files and entries, and resolve it."""
    root = tmp_path / "repo"
    shutil.copytree(spec.HERE, root / "portbench")
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    pb = root / "portbench"
    conf = json.loads((pb / "configs" / "qwen2-vl-7b.json").read_text())
    conf["name"] = "qwen2-vl-7b-w8a8"
    (pb / "configs" / "qwen2-vl-7b-w8a8.json").write_text(json.dumps(conf))
    traffic = json.loads((pb / "traffic" / "video-qa-1024f.json").read_text())
    traffic["frames"] = 2048
    (pb / "traffic" / "video-qa-2048f.json").write_text(json.dumps(traffic))
    name = "qwen2-vl-7b-w8a8.video-qa-2048f"
    (pb / "limits" / f"{name}.json").write_text('{"logit_err": {"limit": 1.0}}')
    (pb / "metrics" / "peak_gib.py").write_text("def read(run):\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name=conf["name"], source=conf["source"], reduced=[],
                                 file="portbench/configs/qwen2-vl-7b-w8a8.json", why="x"))
    bench["workloads"].append(dict(name=name, config=conf["name"], traffic="video-qa-2048f",
                                   chips=1, why="x"))
    bench["per_layer"].append(dict(name="peak_gib", unit="GiB", better="lower",
                                   source="program_counter", layer="device", moves="ttft_s",
                                   workloads=[name]))
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] in ("ttft_s", "tpot_ms"):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell(name, root=root)
    assert cell["traffic"]["frames"] == 2048 and cell["config"]["name"] == conf["name"]
    assert [m["name"] for m in cell["per_layer"]] == ["peak_gib"]
    assert spec.metric_reader("peak_gib", root=root)(None) == 1.0
    for path, data in before.items():  # no file the benchmark had was edited...
        if path.name != "BENCHMARK.json":  # ...but the entries of the benchmark file
            assert path.read_bytes() == data, path


BURSTS = '''"""Clips in bursts: ``burst`` requests due at once, the bursts evenly
spaced; the clips' multiset of lengths, the seed drawing their order."""

import numpy as np

PARAMS = dict(loop="open", rate_per_s=0.8, burst=4, frames=[16, 32, 48, 64, 96],
              output_tokens=[4, 8, 12, 16, 20, 24, 28, 32, 36, 40, 44, 48],
              frame_hw=[448, 252], prefix_tokens=16, question_tokens=48,
              server=dict(batch_slots=4, segment_steps=8, prefill_bucket=8192,
                          vision_cache_slots=0, prefix_cache_slots=0),
              checked_requests=3)


def schedule(traffic, seed, seconds):
    n = max(1, round(traffic["rate_per_s"] * seconds))
    frames, outs, b = traffic["frames"], traffic["output_tokens"], traffic["burst"]
    order = np.random.default_rng([seed % 2**63, 7]).permutation(n)
    return [dict(index=i, frames=frames[order[i] % len(frames)],
                 max_new_tokens=outs[order[i] % len(outs)],
                 arrival_s=float(i // b * b / traffic["rate_per_s"])) for i in range(n)]
'''


OWN_LOOP = '''"""One client through a loop of the mix's own (here the closed loop,
counted)."""

from portbench import run as run_lib

PARAMS = dict(loop="none", frames=1024, frame_hw=[448, 252], prefix_tokens=16, question_tokens=48,
              max_new_tokens=32, checked_requests=2)
DRIVEN = []


def loop(run, engine):
    DRIVEN.append(run.seed)
    run_lib.closed_loop(run, engine)


def samples(run):
    return run_lib.closed_samples(run)
'''

MIXES = {"serve-bursts": (BURSTS, "qwen2-vl-7b.serve-clips"),
         "own-loop": (OWN_LOOP, "qwen2-vl-7b.video-qa-1024f")}


def _with_mix(tmp_path, mix="serve-bursts"):
    """A copy of the benchmark with a new mix given as a generator file
    alone, and a cell that uses it, reporting what ``like`` reports."""
    source, like = MIXES[mix]
    root = tmp_path / "repo"
    shutil.copytree(spec.HERE, root / "portbench")
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "portbench" / "traffic" / f"{mix}.py").write_text(source)
    name = f"qwen2-vl-7b.{mix}"
    (root / "portbench" / "limits" / f"{name}.json").write_text('{"logit_err": {"limit": 1.0}}')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name=name, config="qwen2-vl-7b", traffic=mix, chips=1,
                                   why="x"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, name, before


def test_a_new_mix_is_a_generator_file_only(tmp_path):
    """A mix whose shape the general generator cannot make (bursts) is one
    new ``traffic/<name>.py``: its parameters and schedule are its own, the
    requests the general generator's."""
    from portbench import traffic

    root, name, before = _with_mix(tmp_path)
    cell = spec.cell(name, root=root)
    tr, gen = cell["traffic"], cell["generator"]
    assert tr["burst"] == 4 and gen.request is traffic.request and gen.loop is None
    sched = gen.schedule(tr, 2**31 + 5, 51)
    assert sched == gen.schedule(tr, 2**31 + 5, 51) and len(sched) == round(0.8 * 51)
    arrivals = [r["arrival_s"] for r in sched]
    assert arrivals[:4] == [0.0] * 4 and arrivals[4] == pytest.approx(5.0)
    assert [m["name"] for m in cell["end_to_end"]] == [
        m["name"] for m in spec.cell("qwen2-vl-7b.serve-clips")["end_to_end"]]
    for path, data in before.items():
        if path.name != "BENCHMARK.json":
            assert path.read_bytes() == data, path
