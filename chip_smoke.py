"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Drives retake_tpu_torch's main path once at full Qwen2-VL-2B width and depth
(random bf16 weights from a seed): one ReTaKe request through
``Qwen2VLEngine.generate`` — ViT in 128-frame chunks, DPSelect keyframe
mask, chunked prefill of 32 frames, PivotKV down to 32000 tokens with
position reforge, YaRN x4, greedy decode.

Phases (each prints; any failure raises and exits non-zero):
  1. device and environment        4. end to end, with kernel launch counts
  2. kernel build (nvcc, sm_90a)   5. the same request again, bit-exact
  3. each kernel vs its plain         (tokens, first logits, KV cache)
     PyTorch twin at main-path     6. kernel path vs plain path end to end
     shapes (error + CUDA-event       (first logits, entries PivotKV kept)
     medians)

The last two stdout lines are the kernels record and
``{"ok": true, "device": {...}}``; before them, the card's name and power
limit as nvidia-smi prints them.

Usage:  python3 chip_smoke.py [--frames 512] [--seed 0] [--profile]

``--profile`` adds one more warm request under torch.profiler and prints
the CUDA kernels by device time and the device-busy share of the request.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

GRID_H, GRID_W = 32, 18  # 448x252 / 14
RETAKE_CONFIG = {
    "scaling_factor": 4,
    "longvideo_kwargs": {
        "frame_chunk_size": 128,
        "chunked_prefill_frames": 32,
        "visual_compression": True,
        "visual_compression_kwargs": {
            "compression_ratio": 1.0,
            "compression_method": "Keyframe",
            "patch_sync": False,
            "return_keyframe_mask": True,
        },
        "kvcache_compression": True,
        "kvcache_compression_kwargs": {
            "dynamic_compression_ratio": True,
            "compression_method": "pivotkv",
            "pos_embed_reforge": True,
            "max_input_length": 32000,
        },
    },
}
MAX_NEW_TOKENS = 16
# tolerances, kernel vs plain twin on the same bf16 inputs (N(0, 1) draws).
# K1/K3 write bf16 outputs and round p to bf16 (K1 before normalizing, its
# twin after): each case is held to BF16_STEPS steps of bf16 at its own
# largest output, one step for the final rounding and one for the rest. The
# outputs' size moves 100x between cases (attention over 2304 keys vs over
# 22000), so one absolute figure would be loose where they are small.
# K2 is fp32 arithmetic on both sides (order of sums, exp2 vs exp), on
# column sums of size ~G: 1e-4 abs, 20x the error first seen on the H100.
BF16_STEPS = 2
K2_TOL = 1e-4
# end to end, kernel path vs plain path (bf16, random weights, 64 frames):
# the paths round differently (K1 rounds p to bf16 before normalizing, its
# twin after; K2's sums differ in the last bits, which can swap PivotKV's
# choice between near-equal tokens), and 28 layers carry the differences to
# the logits. On the H100: max|diff| / max|logit| = 0.0154; the bound
# leaves 3x headroom. Greedy tokens are not compared: random weights repeat
# one token whatever the input. What PivotKV kept is compared instead, as
# the share of cached (layer, position) entries both paths hold: 0.985 on
# the H100, so near-ties moved 1.5% of the entries; the bound allows 6x that.
E2E_REL_LOGIT_TOL = 0.05
E2E_MIN_KEPT_AGREEMENT = 0.9


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, what) -> None:
    """Fail the run (an exception, so the exit code is non-zero)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in ms (L2 left warm)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bf16(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def bf16_tol(want) -> float:
    """BF16_STEPS steps of bf16 (8 significant bits) at max|want|."""
    top = want.float().abs().max().item()
    return BF16_STEPS * 2.0 ** (math.floor(math.log2(top)) - 7)


def kept_agreement(a, b, n: int) -> float:
    """Share of the first ``n`` cache entries of every layer that two caches
    hold in common, each entry taken as its (t, h, w) position (a multiset
    per layer, so entries that moved within a chunk still match)."""
    same = 0
    for pa, pb in zip(a.pos[:, :, :n].cpu().numpy(), b.pos[:, :, :n].cpu().numpy()):
        ua, ca = np.unique((pa[0].astype(np.int64) << 40) + (pa[1].astype(np.int64) << 20) + pa[2],
                           return_counts=True)
        ub, cb = np.unique((pb[0].astype(np.int64) << 40) + (pb[1].astype(np.int64) << 20) + pb[2],
                           return_counts=True)
        _, ia, ib = np.intersect1d(ua, ub, return_indices=True)
        same += int(np.minimum(ca[ia], cb[ib]).sum())
    return same / (a.pos.shape[0] * n)


def phase_kernels(dev, records):
    from retake_tpu_torch.ops.cuda import flash_prefill, pivot_scores, vit_attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731

    # K1: 2B heads (12 q / 2 kv, D=128), S=2304, budget 40960
    kv, g, s, d, budget = 2, 6, 2304, 128, 40960
    q = bf16(gen, (kv * g, s, d), dev)
    kc, vc = bf16(gen, (kv, budget, d), dev), bf16(gen, (kv, budget, d), dev)
    kn, vn = bf16(gen, (kv, s, d), dev), bf16(gen, (kv, s, d), dev)
    k1 = flash_prefill.flash_prefill_attention
    worst, ms = 0.0, {}
    for cache_len in (0, 20000):
        for valid_len in (2304, 1999):
            cl, vl = i32(cache_len), i32(valid_len)
            got = k1(q, kc, vc, cl, kn, vn, vl)
            want = flash_prefill.flash_prefill_attention_plain(q, kc, vc, cl, kn, vn, vl)
            torch.cuda.synchronize()
            err, tol = max_err(got, want), bf16_tol(want)
            worst = max(worst, err)
            t_k = cuda_ms(lambda: k1(q, kc, vc, cl, kn, vn, vl), 10)
            t_p = cuda_ms(
                lambda: flash_prefill.flash_prefill_attention_plain(q, kc, vc, cl, kn, vn, vl), 3, 1
            )
            ms[(cache_len, valid_len)] = (t_k, t_p)
            log(f"K1 cache_len={cache_len} valid_len={valid_len}: max|out| "
                f"{want.float().abs().max().item():.3e} max_abs_err {err:.3e} (tol {tol:.3e}) "
                f"kernel {t_k:.3f} ms plain {t_p:.3f} ms")
            check(err <= tol, ("K1", cache_len, valid_len, err, tol))
    del kc, vc, got, want
    records["K1"] = dict(
        name="flash_prefill_attention", route="cuda",
        source="retake_tpu_torch/csrc/flash_prefill.cu",
        replaces="retake_tpu/ops/pallas/flash_prefill.py:182",
        max_abs_err=worst, ms=ms[(20000, 2304)][0], plain_ms=ms[(20000, 2304)][1],
    )

    # K2: S=2304 scoring q/k
    k2 = pivot_scores.pivot_score_sums
    worst, ms = 0.0, {}
    for valid_len in (2304, 1999):
        vl = i32(valid_len)
        got, again = k2(q, kn, vl), k2(q, kn, vl)
        want = pivot_scores.pivot_score_sums_plain(q, kn, vl)
        torch.cuda.synchronize()
        check(torch.equal(got, again), "K2 not bitwise repeatable")
        err = max_err(got, want)
        worst = max(worst, err)
        ms[valid_len] = (cuda_ms(lambda: k2(q, kn, vl), 10),
                         cuda_ms(lambda: pivot_scores.pivot_score_sums_plain(q, kn, vl), 5))
        log(f"K2 valid_len={valid_len}: max_abs_err {err:.3e} (tol {K2_TOL}) "
            f"kernel {ms[valid_len][0]:.3f} ms plain {ms[valid_len][1]:.3f} ms")
        check(err <= K2_TOL, ("K2", valid_len, err))
    records["K2"] = dict(
        name="pivot_score_sums", route="cuda",
        source="retake_tpu_torch/csrc/pivot_scores.cu",
        replaces="retake_tpu/ops/pallas/pivot_scores.py:87",
        max_abs_err=worst, ms=ms[2304][0], plain_ms=ms[2304][1],
    )
    del q, kn, vn

    # K3: ViT attention, 16 heads of 80; error at T=8 and at the main path's
    # 128-frame chunk of 32x18 patches, and at T=8 on a 644x364 frame
    # (46x26 patches); time at T=128
    from retake_tpu_torch.models.qwen2_vl.vision import vision_rotary_tables

    k3 = vit_attention.vit_attention_qkv
    worst = 0.0
    for t, (gh, gw) in ((8, (46, 26)), (8, (GRID_H, GRID_W)), (128, (GRID_H, GRID_W))):
        cos_np, sin_np = vision_rotary_tables(gh, gw, 80, 2)
        cos, sin = torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev)
        qkv = bf16(gen, (t, gh * gw, 16, 3, 80), dev)
        got = k3(qkv, cos, sin)
        want = vit_attention.vit_attention_qkv_plain(qkv, cos, sin)
        torch.cuda.synchronize()
        err, tol = max_err(got, want), bf16_tol(want)
        worst = max(worst, err)
        log(f"K3 T={t} S={gh * gw}: max|out| {want.float().abs().max().item():.3e} "
            f"max_abs_err {err:.3e} (tol {tol:.3e})")
        check(err <= tol, ("K3", t, gh * gw, err, tol))
    t_k = cuda_ms(lambda: k3(qkv, cos, sin), 10)
    t_p = cuda_ms(lambda: vit_attention.vit_attention_qkv_plain(qkv, cos, sin), 3, 1)
    log(f"K3 T=128: kernel {t_k:.3f} ms plain {t_p:.3f} ms")
    records["K3"] = dict(
        name="vit_attention_qkv", route="cuda",
        source="retake_tpu_torch/csrc/vit_attention.cu",
        replaces="retake_tpu/ops/pallas/vit_attention.py:77",
        max_abs_err=worst, ms=t_k, plain_ms=t_p,
    )
    del qkv, got, want
    torch.cuda.empty_cache()


def profile_request(engine, ids, patches, grid):
    """One request under torch.profiler: kernels by device time, busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(ids, patches, grid, max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    # device-side events, minus the "Command Buffer Full" marker (the host
    # waiting for queue room, not device work)
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("Command Buffer")),
                  key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    log(f"[p] profiled request: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%, profiler on)")
    for e in kern[:25]:
        log(f"[p]   {e.self_device_time_total / 1e3:10.1f} ms  x{e.count:<6d} {e.key[:90]}")


def build_request(cfg, num_frames: int, dev, seed: int):
    grid_t = num_frames // cfg.vision.temporal_patch_size
    n_video = grid_t * GRID_H * GRID_W // cfg.vision.spatial_merge_size**2
    rng = np.random.default_rng(seed)
    pre = rng.integers(10, 1000, size=16).tolist()
    post = rng.integers(10, 1000, size=48).tolist()  # the "question"
    ids = np.array(
        pre + [cfg.vision_start_token_id] + [cfg.video_token_id] * n_video
        + [cfg.vision_end_token_id] + post,
        dtype=np.int64,
    )
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    raw = torch.randint(0, 255, (grid_t * GRID_H * GRID_W, cfg.vision.patch_input_dim),
                        generator=gen, device=dev, dtype=torch.int32)
    patches = ((raw.to(torch.float32) - 127.5) / 64.0).to(torch.bfloat16)
    return ids, patches, np.array([[grid_t, GRID_H, GRID_W]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=512, help="raw video frames (2048 = bench)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true", help="profile one more warm request")
    args = ap.parse_args()

    # 1. device and environment
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA GPU",
              file=sys.stderr)
        return 2
    from retake_tpu_torch.models.qwen2_vl import params as params_lib
    from retake_tpu_torch.models.qwen2_vl.config import qwen2_vl_2b
    from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
    from retake_tpu_torch.ops.cuda import _build, flash_prefill, pivot_scores, vit_attention
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine, plan_chunks
    from retake_tpu_torch.utils.config import RetakeConfig

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] device {kind} | {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")

    # 3. kernels vs plain twins
    records = {}
    phase_kernels(dev, records)
    log("[3] kernels match their plain versions")

    # 4. end to end
    cfg = qwen2_vl_2b()
    t0 = time.perf_counter()
    model = Qwen2VLModel(cfg, params_lib.init_params(cfg, seed=args.seed, device=dev))
    torch.cuda.synchronize()
    log(f"[4] 2B model built in {time.perf_counter() - t0:.1f} s")
    rt = RetakeConfig.from_dict(RETAKE_CONFIG)
    engine = Qwen2VLEngine(cfg, model, rt, device=dev)
    ids, patches, grid = build_request(cfg, args.frames, dev, args.seed)
    chunk_tokens = engine.get_chunk_tokens(grid[0])
    ratio = rt.compression_ratio_for(len(ids))
    plan, final_len, _ = plan_chunks(ids, cfg.video_token_id, chunk_tokens, ratio, ratio < 1.0)
    n_video_chunks = sum(p["kind"] == "video" for p in plan)
    n_vit_chunks = -(-int(grid[0][0]) // rt.frame_chunk_size)
    log(f"[4] request: {args.frames} frames, grid {grid[0].tolist()}, {len(ids)} tokens, "
        f"ratio {ratio:.4f}, {len(plan)} prefill steps ({n_video_chunks} video chunks), "
        f"planned cache {final_len}")

    kernels = (flash_prefill.flash_prefill_attention, pivot_scores.pivot_score_sums,
               vit_attention.vit_attention_qkv)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = engine.generate(ids, patches, grid, max_new_tokens=MAX_NEW_TOKENS)
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    toks = res.tokens
    log(f"[4] tokens {toks.tolist()}")
    log(f"[4] launches {launches}")
    check(len(toks) >= 1 and ((toks >= 0) & (toks < cfg.vocab_size)).all(), toks)
    check(res.cache_fill == res.cache_len == final_len, (res.cache_fill, res.cache_len, final_len))
    check(launches["vit_attention_qkv"] >= cfg.vision.depth * n_vit_chunks, launches)
    check(launches["flash_prefill_attention"] >= cfg.num_hidden_layers * len(plan), launches)
    check(launches["pivot_score_sums"] >= cfg.num_hidden_layers * n_video_chunks, launches)
    check(np.isfinite(res.first_logits).all(), "non-finite first-token logits")
    dec_ms = 1e3 * res.decode_seconds / max(len(toks) - 1, 1)
    log(f"[4] cold: TTFT {res.prefill_seconds:.3f} s, decode {dec_ms:.2f} ms/token over "
        f"{len(toks) - 1} tokens, peak memory {peak / 2**30:.2f} GiB")

    # 5. determinism (warm run, with per-stage timing): the whole request is
    # bit-exact, K2's fixed-order sums included, so PivotKV keeps the same
    # entries and the cache and the first-token logits repeat exactly
    os.environ["RETAKE_PROFILE"] = "1"
    res2 = engine.generate(ids, patches, grid, max_new_tokens=MAX_NEW_TOKENS)
    os.environ.pop("RETAKE_PROFILE")
    n = int(res.cache.length)
    same = {
        "tokens": np.array_equal(res2.tokens, toks),
        "first_logits": np.array_equal(res2.first_logits, res.first_logits),
        "cache_length": n == int(res2.cache.length),
        **{f"cache_{f}": torch.equal(getattr(res.cache, f)[:, :, :n], getattr(res2.cache, f)[:, :, :n])
           for f in ("k", "v", "pos")},
    }
    log(f"[5] bit-exact repeat: {same}")
    check(all(same.values()), same)
    dec_ms2 = 1e3 * res2.decode_seconds / max(len(res2.tokens) - 1, 1)
    log(f"[5] warm (stage fences on): TTFT {res2.prefill_seconds:.3f} s, "
        f"decode {dec_ms2:.2f} ms/token, stages "
        + json.dumps({k: round(v, 4) for k, v in (res2.stages or {}).items()}))
    del res, res2
    if args.profile:
        profile_request(engine, ids, patches, grid)
    del engine, patches
    torch.cuda.empty_cache()

    # 6. kernel path vs plain path, 64 frames, PivotKV compressing every
    # video chunk (max_input_length below the 64-frame input)
    ids6, patches6, grid6 = build_request(cfg, 64, dev, args.seed + 1)
    rd = json.loads(json.dumps(RETAKE_CONFIG))
    rd["longvideo_kwargs"]["kvcache_compression_kwargs"]["max_input_length"] = 3000
    out = {}
    for impl in ("pallas", "xla"):
        rd["attn_implementation"] = impl
        eng = Qwen2VLEngine(cfg, model, RetakeConfig.from_dict(rd), device=dev)
        out[impl] = eng.generate(ids6, patches6, grid6, max_new_tokens=MAX_NEW_TOKENS)
    a, b = out["pallas"], out["xla"]
    diff = float(np.abs(a.first_logits - b.first_logits).max())
    rel = diff / float(np.abs(b.first_logits).max())
    check(a.cache_fill == b.cache_fill, (a.cache_fill, b.cache_fill))
    kept = kept_agreement(a.cache, b.cache, a.cache_fill)
    log(f"[6] 64 frames, {len(ids6)} tokens, cache {a.cache_fill}: first-token logits "
        f"max|diff| {diff:.4e} (rel {rel:.4f}, bound {E2E_REL_LOGIT_TOL}); kept entries "
        f"in common {kept:.4f} (bound {E2E_MIN_KEPT_AGREEMENT}); tokens "
        f"{a.tokens[:4].tolist()} / {b.tokens[:4].tolist()}")
    check(rel <= E2E_REL_LOGIT_TOL and kept >= E2E_MIN_KEPT_AGREEMENT, (rel, kept))

    kernel_line = {"kernels": []}
    for key, fn in zip(("K1", "K2", "K3"), kernels):
        rec = dict(records[key])
        rec["launches"] = launches[fn.__name__]
        kernel_line["kernels"].append(rec)
    log(smi)
    print(json.dumps(kernel_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
