"""Resolve a cell of ``BENCHMARK.json`` by name: its configuration file,
its model family (``families/<family>.py``, named by the configuration's
``family`` key), its traffic mix (parameters in ``traffic/<name>.json``; a
generator of its own, with or without them, in ``traffic/<name>.py``), its
limits, the metric readers it reports and the kernels a traced run records
(``kernels/<k>.py``), each found by the name the benchmark file or the
configuration gives it. Nothing here is specific to one cell: a new cell,
configuration, model family, mix, metric or kernel is new files and
entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """Does ``cell`` report ``metric`` (its ``workloads`` list, or all)?"""
    return cell in metric.get("workloads", [cell])


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(run)`` of ``portbench/metrics/<name>.py``."""
    return _module(root / "portbench" / "metrics" / f"{name}.py", f"portbench_metric_{name}").read


def traffic_mix(name: str, root: Path = ROOT):
    """(parameters, generator) of mix ``name``: the parameters of
    ``traffic/<name>.json`` over the ``PARAMS`` of ``traffic/<name>.py``,
    and the generator of that module where it exists
    (``portbench.traffic.generator``)."""
    from portbench import traffic as traffic_lib

    d = root / "portbench" / "traffic"
    js, py = d / f"{name}.json", d / f"{name}.py"
    if not js.exists() and not py.exists():
        raise SystemExit(f"traffic mix {name!r} has neither {js.name} nor {py.name}")
    mod = _module(py, f"portbench_traffic_{name}") if py.exists() else None
    params = dict(getattr(mod, "PARAMS", {}))
    if js.exists():
        params.update(load_json(js))
    return params, traffic_lib.generator(mod)


def family(name: str, root: Path = ROOT):
    """The module of model family ``name``: ``families/<name>.py``, with its
    ``tree``, ``build``, ``layout``, ``request``, ``reference_logits`` and
    ``request_flops``."""
    path = root / "portbench" / "families" / f"{name}.py"
    if not path.exists():
        raise SystemExit(f"model family {name!r} has no {path.relative_to(root)}")
    return _module(path, f"portbench_family_{name}")


def kernels(root: Path = ROOT) -> Dict[str, object]:
    """Every kernel module ``kernels/<k>.py`` by its name ``k``, each with
    ``ENTRY``, ``record``, ``DEVICE_NAMES`` and ``count``."""
    return {p.stem: _module(p, f"portbench_kernel_{p.stem}")
            for p in sorted((root / "portbench" / "kernels").glob("*.py"))}


def cell(name: str, root: Path = ROOT) -> Dict:
    """Everything one run of cell ``name`` needs."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    fam = family(config["family"], root)
    traffic, gen = traffic_mix(w["traffic"], root)
    limits = load_json(root / "portbench" / "limits" / f"{name}.json")
    e2e: List[dict] = [m for m in bench["end_to_end"] if reports(m, name)]
    per_layer: List[dict] = [m for m in bench["per_layer"] if reports(m, name)]
    return dict(name=name, workload=w, config=config, family=fam, traffic=traffic,
                generator=gen, kernels=kernels(root), limits=limits, end_to_end=e2e,
                per_layer=per_layer)
