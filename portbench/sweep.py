"""Find the highest arrival rate an open-loop cell's server sustains: one
process, the cell's model, mix and server, a window of ``--seconds`` at
each rate in turn.

    python3 -m portbench.sweep --workload <cell> --rates 0.4,0.6,0.8 [--seeds 1,2] [--seconds 51]

Weights come from the first seed; each seed draws a rate's schedule and
inputs as a run would, and is served and timed as a run serves and times
it (``run.serve_window``). Prints one JSON line a rate and seed (a seed
given twice is served twice): requests, time to the first token from the
due time (median, 75th and 90th percentiles), queue wait in the first and
the last quarter of arrivals (a wait that grows through the window is a
backlog), the window's tokens per second and how long after the window the
last request finished. The cell's rate is set once, by hand, from this output.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from portbench import program, run as run_lib, spec as spec_lib, traffic as traffic_lib


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--seeds", default="20260")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = spec_lib.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    run = run_lib.Run(cell, seeds[0], args.seconds, False, "cuda")
    tree = run.family.tree(run.config, seeds[0], "cuda")
    with torch.no_grad():
        engine = run.family.build(run.config, tree, "cuda")
        settings = run.traffic["server"]
        warm = [dict(index=-1 - k, frames=f, max_new_tokens=settings["segment_steps"] + 1,
                     arrival_s=0.0) for k, f in enumerate(sorted(set(run.traffic["frames"])))]
        program.server(engine, settings).run(run_lib.serve_requests(run, warm))
        for rate, seed in [(float(r), s) for r in args.rates.split(",") for s in seeds]:
            tr = dict(run.traffic, rate_per_s=rate)
            run.seed = seed
            sched = traffic_lib.schedule(tr, seed, args.seconds)
            reqs = run_lib.serve_requests(run, sched)
            arrivals = [s["arrival_s"] for s in sched]
            res, recs, window = run_lib.serve_window(program.server(engine, settings), reqs,
                                                     arrivals, sync=torch.cuda.synchronize)
            del reqs
            ttft = [h["first_token_s"] - a for h, a in zip(recs, arrivals)]
            wait = [r.prefill_start_s - r.arrival_s for r in res]
            q = max(1, len(res) // 4)
            print(json.dumps(dict(
                rate=rate, seed=seed, requests=len(res), failed=sum(bool(r.cancelled) for r in res),
                ttft_p50_s=float(np.median(ttft)), ttft_p75_s=float(np.quantile(ttft, 0.75)),
                ttft_p90_s=float(np.quantile(ttft, 0.9)),
                wait_first_quarter_s=float(np.mean(wait[:q])),
                wait_last_quarter_s=float(np.mean(wait[-q:])),
                tokens_per_s=sum(len(h["tokens"]) for h in recs) / window,
                drain_s=window - args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
