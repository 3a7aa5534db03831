"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: build the cell's parameter tree on the device from the seed, the
engine over it, and warm up the cell's own shapes (set-up); measure for
``--seconds``; then compare what the window served with the plain float32
reference (``portbench/reference``) and print one JSON line. With
``--trace 1`` the engine's stage timer is on in the window, a few requests
after it run under ``torch.profiler``, and the line carries the cell's
per-layer metrics instead of its end-to-end ones.

Exits non-zero without a result when CUDA is absent or has fewer cards
than the cell asks for, and when the process holds a JAX module or the JAX
package once the window has closed.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the card's host turns bytecode off: keep a fixed bytecode cache here
sys.pycache_prefix = str(HERE / "_pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import compare, program, spec as spec_lib, traffic as traffic_lib  # noqa: E402
from portbench import trace as trace_lib  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "retake_tpu")
TRACE_DIR = HERE / "_trace"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Run:
    """What one run of a cell measured, for the metric readers
    (``portbench/metrics/<name>.py``: ``read(run)``)."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, device):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.family = cell.get("family") or spec_lib.family(self.config["family"])  # its module
        self.kernel_modules = cell.get("kernels") or spec_lib.kernels()
        self.setup_s = None
        self.requests = []  # closed loop: one record a request
        self.schedule, self.results, self.stats = [], [], {}  # open loop
        self.window_s = None
        self.profiles = {}  # name -> trace.Trace
        self.kernels = {}  # kernel name -> calls with their shapes (program.KernelCalls)
        self.checks = {}  # compared number -> (value, limit)
        self.memory_peak = 0
        self.tap = program.LogitTap()  # the served logits of the window
        self.readings = {}  # the comparison's readings (portbench/compare.py)
        self.gen = cell.get("generator") or traffic_lib.generator()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def request(self, index: int, frames: int) -> dict:
        return self.gen.request(self.family, self.config, self.traffic, self.seed, index,
                                frames, self.device)


# ---------- the closed loop: one client, long videos ----------


def closed_loop(run: Run, engine) -> None:
    """One client: request i + 1 is sent when request i has finished, the
    first at once, the last the one sent before ``seconds`` had passed. Its
    time to the first token runs on the harness's clock from the call to
    its first logits on the device (``LogitTap.first_at``), its wall to
    the return of the call after a synchronize."""
    tr = run.traffic
    frames, new = tr["frames"], tr["max_new_tokens"]
    # warm-up: the cell's shapes, its whole decode with it (the decode's
    # CUDA graph is captured from the third token on, so a shorter warm-up
    # leaves the process's first capture to the window)
    program.generate(engine, run.request(-1, frames), new)
    run.sync()
    run.setup_s = time.perf_counter() - T_START
    if run.trace:
        os.environ["RETAKE_PROFILE"] = "1"  # the engine's stage timer (CUDA events)
    t0 = time.perf_counter()
    with run.tap.tapping():
        while not run.requests or time.perf_counter() - t0 < run.seconds:
            i = len(run.requests)
            req = run.request(i, frames)
            run.sync()
            run.tap.key = i
            ts = time.perf_counter()
            res = program.generate(engine, req, new)
            run.sync()
            wall = time.perf_counter() - ts
            run.tap.key = None
            first = run.tap.first_at.get(i)
            run.requests.append(dict(index=i, frames=frames,
                                     ttft_s=None if first is None else first - ts,
                                     wall_s=wall, tokens=np.asarray(res.tokens),
                                     stages=dict(res.stages or {})))
            del req, res
            run.tap.to_host(i)
    run.window_s = time.perf_counter() - t0
    os.environ["RETAKE_PROFILE"] = "0"
    seen = [r for r in run.requests if r["ttft_s"] is not None]
    print("portbench: per request, ttft_s " + " ".join(f"{r['ttft_s']:.4f}" for r in seen)
          + "; decode_s " + " ".join(f"{r['wall_s'] - r['ttft_s']:.4f}" for r in seen),
          file=sys.stderr)
    run.memory_peak = torch.cuda.max_memory_allocated() if run.device.type == "cuda" else 0
    if run.trace:
        req = run.request(10**6, frames)
        calls = program.KernelCalls(run.kernel_modules)
        with calls.recording():
            _, run.profiles["prefill"] = trace_lib.profile(
                lambda: program.generate(engine, req, 1), str(TRACE_DIR), "prefill")
        run.kernels = calls.resolved()
        _, run.profiles["request"] = trace_lib.profile(
            lambda: program.generate(engine, req, new), str(TRACE_DIR), "request")


def closed_samples(run: Run) -> list:
    """The requests the check compares: the window's last (the most served
    state behind it) and ``checked_requests`` - 1 more of the window's,
    drawn from the seed."""
    last = len(run.requests) - 1
    if last < 0:
        return []
    rng = np.random.default_rng([run.seed % 2**63, 11])
    n = min(run.traffic.get("checked_requests", 1), last + 1) - 1
    pick = [last] + (rng.choice(last, size=n, replace=False).tolist() if n > 0 else [])
    return [run.requests[i] for i in sorted(pick)]


# ---------- the open loop: many users, short clips ----------


def serve_requests(run: Run, sched: list) -> list:
    out = []
    for s in sched:
        req = run.request(s["index"], s["frames"])
        out.append(dict(program.generate_kwargs(req), max_new_tokens=s["max_new_tokens"]))
    return out


def serve_window(srv, reqs: list, arrivals: list, tap=None, sync=None):
    """Serve ``reqs`` due at ``arrivals`` (seconds from the call) through the
    server's own ``run``. The harness's clock stamps each request's first
    and last streamed tokens (the server's ``on_tokens``) and the window,
    from the call to the last completion. Returns (the server's results,
    one record a request: the streamed ``tokens``, ``first_token_s`` and
    ``finish_s`` from the call; the window's seconds)."""
    recs = [dict(tokens=[], first_token_s=None, finish_s=None) for _ in reqs]
    t0 = time.perf_counter()

    def on_tokens(rid, toks):
        t = time.perf_counter() - t0
        rec = recs[rid]
        if rec["first_token_s"] is None:
            rec["first_token_s"] = t
        rec["finish_s"] = t
        rec["tokens"].extend(int(x) for x in toks)

    with tap.tapping(srv) if tap is not None else contextlib.nullcontext():
        results = srv.run(reqs, arrivals, on_tokens=on_tokens)
    if sync is not None:
        sync()
    return results, recs, time.perf_counter() - t0


def open_loop(run: Run, engine) -> None:
    """Many users: the schedule's requests, due at fixed times on the
    harness's clock, through ``ContinuousServer.run``. A request's time to
    the first token runs from when it was due; the window from its start to
    the last completion."""
    tr = run.traffic
    settings = tr["server"]
    warm = [dict(index=-1 - k, frames=f, max_new_tokens=settings["segment_steps"] + 1,
                 arrival_s=0.0) for k, f in enumerate(sorted(set(tr["frames"])))]
    program.server(engine, settings).run(serve_requests(run, warm))
    run.sync()
    run.schedule = run.gen.schedule(tr, run.seed, run.seconds)
    reqs = serve_requests(run, run.schedule)
    arrivals = [s["arrival_s"] for s in run.schedule]
    run.sync()
    run.setup_s = time.perf_counter() - T_START
    srv = program.server(engine, settings)
    run.tap = program.LogitTap(watch=[s["index"] for s in open_samples(run)],
                               index_of={id(r["input_ids"]): s["index"]
                                         for r, s in zip(reqs, run.schedule)})
    results, recs, run.window_s = serve_window(srv, reqs, arrivals, run.tap, run.sync)
    run.results = [dict(index=s["index"], frames=s["frames"], max_new_tokens=s["max_new_tokens"],
                        arrival_s=s["arrival_s"], first_token_s=h["first_token_s"],
                        finish_s=h["finish_s"], queue_wait_s=r.prefill_start_s - r.arrival_s,
                        tokens=np.asarray(h["tokens"], np.int64),
                        failed=bool(r.cancelled or r.error or h["first_token_s"] is None
                                    or h["tokens"] != [int(x) for x in r.tokens]))
                   for s, r, h in zip(run.schedule, results, recs)]
    run.stats = dict(srv.stats, segment_steps=srv.seg, batch_slots=srv.b)
    run.memory_peak = torch.cuda.max_memory_allocated() if run.device.type == "cuda" else 0
    if run.trace:
        span = tr.get("profiled_seconds", run.seconds)
        part = [i for i, a in enumerate(arrivals) if a < span]
        calls = program.KernelCalls(run.kernel_modules)
        with calls.recording():
            _, run.profiles["serve"] = trace_lib.profile(
                lambda: program.server(engine, settings).run(
                    [reqs[i] for i in part], [arrivals[i] for i in part]),
                str(TRACE_DIR), "serve")
        run.kernels = calls.resolved()
    del reqs


def open_samples(run: Run) -> list:
    """The requests the check compares, drawn from the seed before the
    window: ``checked_requests`` of those due, the longest (frames, then
    tokens) always among them."""
    sched = run.schedule
    longest = max(range(len(sched)),
                  key=lambda i: (sched[i]["frames"], sched[i]["max_new_tokens"]))
    rest = [i for i in range(len(sched)) if i != longest]
    rng = np.random.default_rng([run.seed % 2**63, 13])
    n = min(run.traffic.get("checked_requests", 1) - 1, len(rest))
    pick = [longest] + (rng.choice(rest, size=n, replace=False).tolist() if n > 0 else [])
    return [sched[i] for i in sorted(pick)]


def open_served(run: Run) -> list:
    """The served records of ``open_samples``."""
    by_index = {r["index"]: r for r in run.results}
    return [by_index[s["index"]] for s in open_samples(run)]


LOOPS = {"closed": (closed_loop, closed_samples), "open": (open_loop, open_served)}


# ---------- the comparison ----------


def reference_logits(run: Run, tree: dict, rec: dict, streams: list) -> list:
    """For each token stream served for request ``rec``, the reference's
    logits at its positions (one reference prefill for all streams)."""
    req = run.request(rec["index"], rec["frames"])
    return run.family.reference_logits(tree, run.config, req, streams, run.device)


def judge(run: Run, tree: dict, tap, rec: dict) -> dict:
    """The comparison's readings for one served request: the logits its
    timed path computed and the tokens it served, against the reference's
    logits on the same prompt and served prefix."""
    tokens = rec["tokens"]
    ref = reference_logits(run, tree, rec, [tokens])[0]
    return compare.readings(ref, tap.stacked(rec["index"], len(tokens)), tokens)


def check(run: Run, tree: dict, samples: list) -> bool:
    """Each compared number over the sampled requests, held to the cell's
    limit for it (``portbench/limits/<cell>.json``)."""
    limits = run.cell["limits"]
    got = [judge(run, tree, run.tap, rec) for rec in samples if not rec.get("failed")]
    if not got:
        run.checks = {k: (float("inf"), v["limit"]) for k, v in limits.items()}
        return False
    run.readings = compare.worst(got)
    run.checks = {k: (run.readings.get(k, float("inf")), v["limit"]) for k, v in limits.items()}
    return all(value <= limit for value, limit in run.checks.values())


# ---------- one run ----------


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set up, measure and check one run of ``cell``; the result's fields."""
    run = Run(cell, seed, seconds, trace, device)
    tree = run.family.tree(run.config, seed, run.device)
    with torch.no_grad():
        engine = run.family.build(run.config, tree, run.device)
        drive, sampled = run.gen.loop or LOOPS[run.traffic["loop"]]
        drive(run, engine)
        del engine
        gc.collect()
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        samples = sampled(run)
        t_ref = time.perf_counter()
        correct = check(run, tree, samples)
        print(f"portbench: window {run.window_s:.3f} s, reference {time.perf_counter() - t_ref:.3f} s "
              f"over {len(samples)} request(s); readings {run.readings}", file=sys.stderr)
    del tree
    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = spec_lib.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    failed = sum(bool(r.get("failed")) for r in run.requests + run.results)
    attempted = len(run.requests) + len(run.results)
    out = dict(correct=bool(correct and failed == 0), attempted=attempted, failed=failed,
               metrics=metrics, device=device_record(run))
    if trace and run.profiles:
        profs = list(run.profiles.values())
        out["device"]["busy_s"] = sum(p.busy_s for p in profs)
        out["device"]["window_s"] = sum(p.wall_s for p in profs)
        out["breakdown"] = breakdown(profs)
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out


def device_record(run: Run) -> dict:
    if run.device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=0, memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=run.cell["workload"]["chips"], memory_peak_bytes=int(run.memory_peak))


def breakdown(profs: list) -> dict:
    ops, gaps = {}, {}
    for p in profs:
        for name, s in p.top_ops(50):
            ops[name] = ops.get(name, 0.0) + s
        for name, s in p.idle_gaps(50):
            gaps[name] = gaps.get(name, 0.0) + s

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="one run of a cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = spec_lib.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference's products: full float32
    torch.backends.cudnn.allow_tf32 = False
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
