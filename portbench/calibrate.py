"""The readings a cell's correctness limit is set from, on the chip.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 15]

For each seed, in one process: the cell's parameter tree from that seed,
the program over it (the engine's own entry point, at the cell's shapes),
and the readings of the comparison that decides ``correct``
(``portbench/compare.py``, ``run.judge``). For each control seed also the
control: the same program with its lower-precision path switched on (W8A8
linears and an int8 KV cache), on the same requests, judged alike. Closed-loop cells serve
one request a seed; open-loop cells a ``--seconds`` window at the cell's
load, checked as a run checks it. Prints one JSON line a seed; the limit
lies between the program's largest reading and the control's smallest.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from portbench import compare, program, run as run_lib, spec as spec_lib, traffic as traffic_lib


def _closed(run, engine) -> dict:
    tr = run.traffic
    req = run.request(0, tr["frames"])
    tap = program.LogitTap()
    with tap.tapping():
        tap.key = 0
        res = program.generate(engine, req, tr["max_new_tokens"])
        tap.key = None
    tap.to_host(0)
    return {0: dict(index=0, frames=tr["frames"], tokens=np.asarray(res.tokens), failed=False,
                    tap=tap)}


def _open(run, engine, sched: list, watch: list) -> dict:
    reqs = run_lib.serve_requests(run, sched)
    srv = program.server(engine, run.traffic["server"])
    tap = program.LogitTap(watch=watch, index_of={id(r["input_ids"]): s["index"]
                                                  for r, s in zip(reqs, sched)})
    with tap.tapping(srv):
        res = srv.run(reqs, [s["arrival_s"] for s in sched])
    return {s["index"]: dict(index=s["index"], frames=s["frames"], tokens=np.asarray(r.tokens),
                             failed=bool(r.cancelled or r.error), tap=tap)
            for s, r in zip(sched, res)}


def readings(cell: dict, seed: int, control: bool, seconds: float, device) -> dict:
    """The program's (and with ``control`` the control's) readings of the
    comparison (``portbench/compare.py``) on one seed, worst over the
    requests a run of the cell would check."""
    run = run_lib.Run(cell, seed, seconds, False, device)
    tree = run.family.tree(run.config, seed, device)
    closed = run.traffic["loop"] == "closed"
    if closed:
        picks = [dict(index=0, frames=run.traffic["frames"])]
    else:
        run.schedule = traffic_lib.schedule(run.traffic, seed, seconds)
        picks = run_lib.open_samples(run)
    served = {}
    with torch.no_grad():
        for name in ("program", "control") if control else ("program",):
            engine = run.family.build(run.config, tree, device, control=name == "control")
            served[name] = (_closed(run, engine) if closed else
                            _open(run, engine, run.schedule, [p["index"] for p in picks]))
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        got = {k: [] for k in served}
        for rec in picks:
            for k in served:
                s = served[k][rec["index"]]
                if not s["failed"]:
                    got[k].append(run_lib.judge(run, tree, s["tap"], s))
    del tree, served
    gc.collect()
    torch.cuda.empty_cache()
    return {"seed": seed, "requests": len(picks), **{k: compare.worst(v) for k, v in got.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=15.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec_lib.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(controls - set(seeds)):
        t0 = time.perf_counter()
        out = readings(cell, seed, seed in controls, args.seconds, "cuda")
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
