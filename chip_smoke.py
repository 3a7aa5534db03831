"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Drives retake_tpu_torch's main paths at full width and depth with random
weights from a seed. Qwen2-VL-2B in bf16: one ReTaKe request through
``Qwen2VLEngine.generate`` — ViT in 128-frame chunks, DPSelect keyframe
mask, chunked prefill of 32 frames, PivotKV down to 32000 tokens with
position reforge, YaRN x4, greedy decode — and six staggered requests
through the continuous-batching server ``ContinuousServer.run`` (4 decode
slots over the gap-layout cache, mid-decode admission, compaction).
Qwen2-VL-7B in the repo's serving configuration (``quantization: w8a8``,
``kv_cache_dtype: int8``): the same request and the same server, through
the int8-KV modes of K1 and K4.

Phases (each prints; any failure raises and exits non-zero):
  1. device and environment        7. the server: 6 requests, 4 slots, with
  2. kernel build (nvcc, sm_90a)      kernel launch counts
  3. each kernel (and int8 mode)   8. one batched decode step, kernel path
     vs its plain PyTorch twin at     vs plain path (first-step logits)
     main-path shapes (error,      9. weight-only int8 2B request vs the
     CUDA-event medians, repeat),     bf16 one (first logits)
     its bound, and the time of
     SDPA where one PyTorch call
     computes the same function;
     K1 at four cache fill levels;
     K2 at 2B and 7B heads; K2's
     and K4's device time per call
     (CUDA-graph replay); K1, K2
     and K3 at the shapes of
     phases 12-16, K1 at phase
     17's recapture text step,
     K1 and K2 at phase 22's
     LLaVA-Video-7B chunk,
     K1-int8 at 2B heads
     (phase 23's shape)
  4. end to end, with kernel      10. 7B W8A8 + int8-KV request: launch
     launch counts                    counts, bit-exact repeat (cache and
  5. the same request again,          scales), kernel vs plain path
     bit-exact (tokens, first     11. 7B server with the int8 KV cache:
     logits, KV cache)                6 requests, 4 slots, compaction of the
  6. kernel path vs plain path        scale planes, K4-int8 launch counts
     end to end (first logits,
     entries PivotKV kept)
 12. prompt-guided compression (the question in every video chunk): as
     4-6, and the planned cache pre + sum(keep) + post
 13. images: two images of different grids alone, and image + video (64
     frames) + image; K3 launches per image, kernel vs plain path
 14. reuse across three questions: encode_video then
     generate(video_features=), encode_prefix then generate(prefix=), each
     bit-exact against inline (tokens, first logits), TTFT beside inline's,
     PrefixMismatch for another prompt prefix; after phase 11 the same
     prefix reuse on 7B (int8 KV) at 64 frames
 15. prompt-lookup speculative decode: tokens per verify step, K1 launches,
     token agreement with greedy
 16. sampling: a seed repeats bit-exactly, temperature 1e-4 gives greedy,
     top-k / top-p run; sampled generate_batch (3 requests) and the phase-7
     server mix sampled, with K4 launches and agreement with sequential
 17. online serving (``start_online``) with the vision-feature and prefix
     caches: two videos, six questions from two submitting threads, a
     forced budget recapture, a full backlog (queue.Full), a malformed and
     an expired request; stats, launches per admission kind, K4 in every
     segment, agreement with ``generate(prefix=...)``
 18. the HTTP front end on 127.0.0.1: /healthz, a question about a JPEG
     frame directory (miss: frames, ViT, capture), the same question again
     (prefix hit: no frame loading, no K3) blocking and streamed, /metrics,
     503 on a full backlog
 19. the "flash" attention arm (configs/retake_demo.yaml's) on the phase-4
     request against "pallas": first logits, PivotKV-kept entries, no K1 or
     K2, each arm's TTFT; generate_batch under "flash" (K4)
 20. MA-LLM and MA-LLM-hard (ratio 0.5, patch_sync off and on) at 128
     frames: feature shapes, bit-exact repeat, K3 launches, a request;
     malm_compress's time at 64 merges
 21. weights and configs from disk (2B): ``RetakeConfig.from_yaml`` of every
     file under configs/; the random tree as two HF safetensors shards with
     an index through ``load_safetensors(device="cuda")``, bit-identical
     (seconds, peak memory); a weight-only int8 tree through
     ``save_params`` / ``load_checked``, the same request from both; the
     port demo (``retake_tpu_torch.demo``) on random weights, 64 frames
 22. LLaVA-Video-7B at full width and depth (Qwen2-7B text, SigLIP so400m)
     under configs/llava_video/retake_llava-video_videomme.yaml with the
     kernels, 256 frames (``--llava-frames``): TTFT cold and warm, stages,
     peak memory, bit-exact repeat, K1 / K2 launches per step and chunk, no
     K3; SigLIP's time; at 64 frames the kernel path against the plain arm
     and the published "flash" arm, two ``prefix=`` questions bit-exact, a
     3-request ``generate_batch`` (K4), W8A8 against bf16
 23. the eval runner (``retake_tpu_torch.eval.infer_eval``) on 2B under
     configs/qwen2_vl/retake_qwen2-vl_videomme_tpu_serving.yaml (W8A8, int8
     KV, eval_batch_size 4) over a synthetic Video-MME benchmark (4 videos of
     512 JPEG frames, 2 questions each; the runs take the first 2 videos and
     decode 16 tokens a sample): the quantizer tool (``--vit``) over phase
     21's checkpoint, bit-identical to quantizing the loaded tree; one
     process in-process (K1-int8, K2, K3 in every sample, no K4; journal and
     the three files); a resume that runs nothing; the CLI as two processes
     joined by torch.distributed (gloo) on the card over 1 of the videos;
     reuse of each video's features and prefix, token-exact against the
     one-process run; the host pipeline at 2048 frames: the native
     library's state (its patchify half must build), which path decoded the
     frames, the native patchify beside the numpy path
 24. tensor parallelism, two rank processes of this script (gloo on one
     card, NCCL on two): (a) 7B in the serving config at ``--frames``, (b)
     three of phase 11's requests through ``ContinuousServer.run``, (d) the
     first of them online with a keyed video asked twice, from two threads,
     an expired and a malformed request, then the HTTP front end (miss,
     prefix hit blocking and streamed), (c) LLaVA-Video-7B at 64 frames and
     ``generate_batch``; the ranks bit-equal, held to phases 10, 11 and 22
 25. the first-checkpoint gate (``retake_tpu_torch.tools.first_checkpoint_gate``)
     on phase 21's 2B checkpoint, a 64-frame JPEG directory and a 2-sample
     Video-MME slice of 512 frames: every stage in this process under
     copies of the published configs with ``attn_implementation: "pallas"``
     (launches per stage; K1, K1-int8, K2, K3 and K4 each at least once;
     no stage errs, prefix reuse token-exact, serving-decode agreement >=
     0.7, HTTP 200, eval_results.csv); beside it the gate as a user runs
     it, a process under the published configs (one JSON line, every key);
     then the reference's TTFT / TPOT protocol (``tools/cal_ttft.py``) at
     512 frames

The last two stdout lines are the kernels record and
``{"ok": true, "device": {...}}``; before them, the card's name and power
limit as nvidia-smi prints them.

Usage:  python3 chip_smoke.py [--frames 512] [--seed 0] [--profile] [--llava-frames 256]

``--frames`` sets the single request of phases 4-5, 10, 12, 14-16 (2048 =
the bench geometry). ``--profile`` adds one more warm request (2B and 7B) and
one more batched decode step under torch.profiler and prints the CUDA
kernels by device time and the device-busy share of each.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

from retake_tpu_torch.tools.bench_model import (
    GRID_H, GRID_W, RETAKE_CONFIG, build_request, random_patches)

MAX_NEW_TOKENS = 16
# the serving phase: ContinuousServer(engine, **SERVE_KW) over six requests
# (frames, arrival s, own max_new_tokens or None); seeds 0-5
SERVE_KW = dict(batch_slots=4, segment_steps=8, max_new_tokens=32, prefill_bucket=40960,
                gap_capacity=32)
SERVE_REQUESTS = [(512, 0.0, None), (64, 0.0, 17), (256, 0.0, None), (128, 0.0, None),
                  (64, 1.0, None), (128, 2.0, None)]
# 7B: the serving config of configs/qwen2_vl/retake_qwen2-vl_videomme_tpu_serving.yaml
# on top of RETAKE_CONFIG (its eval_batch_size 4 is SERVE_KW's batch_slots)
SERVING_7B = {"attn_implementation": "pallas", "quantization": "w8a8", "kv_cache_dtype": "int8"}
# tolerances, kernel vs plain twin on the same bf16 inputs (N(0, 1) draws).
# K1/K3 write bf16 outputs and round p to bf16 (the kernels before
# normalizing, their twins after): each case is held to BF16_STEPS steps of
# bf16 at its own largest output, one step for the final rounding and one
# for the rest. The outputs' size moves 100x between cases (attention over
# 2304 keys vs over 22000), so one absolute figure would be loose where
# they are small.
# K2 is fp32 arithmetic on both sides (order of sums, exp2 vs exp), on
# column sums of size ~G: 1e-4 abs, 20x the error first seen on the H100.
BF16_STEPS = 2
K2_TOL = 1e-4
# end to end, kernel path vs plain path (bf16, random weights, 64 frames):
# the paths round differently (K1 and K3 round p to bf16 before
# normalizing, their twins after; K2's sums differ in the last bits, which
# can swap PivotKV's choice between near-equal tokens), and 28 layers carry
# the differences to the logits. On the H100: max|diff| / max|logit| =
# 0.0154; the bound leaves 3x headroom. Greedy tokens are not compared:
# random weights repeat one token whatever the input. What PivotKV kept is
# compared instead, as the share of cached (layer, position) entries both
# paths hold: 0.985 on the H100, so near-ties moved 1.5% of the entries; the
# bound allows 6x that.
E2E_REL_LOGIT_TOL = 0.05
E2E_MIN_KEPT_AGREEMENT = 0.9
# the same comparison for 7B under W8A8 + int8 KV (phase 10). The plain
# path differs from the kernel path by more than rounding: its chunk
# attention keeps the chunk's keys bf16 and quantizes them only at the
# cache append, as the JAX "xla" arm does. First H100 reading: rel 0.0363,
# 96.23% of the kept entries in common; the bounds allow 3x the logit
# difference and 3x the disagreement.
E2E7_REL_LOGIT_TOL = 0.11
E2E7_MIN_KEPT_AGREEMENT = 0.88
# weight-only int8 vs bf16 on the same 2B weights and request (phase 9):
# per-channel 8-bit weights through 28 layers. First H100 reading: rel
# 0.0374, cosine 0.99911; the bounds allow 3x the difference and 3x the
# distance of the cosine from 1.
W8_REL_LOGIT_TOL = 0.12
W8_MIN_COSINE = 0.997
# K4 against its plain twin: the merged attention output (bf16) to
# BF16_STEPS steps of bf16 at each case's largest output; the row max m is
# a max of fp32 dot products, summed in another order: 1e-3 abs
K4_M_TOL = 1e-3
# published dense peaks of one H100 SXM (NVIDIA data sheet, at 700 W): the
# least time of a kernel is the larger of its operations over the bf16
# tensor-core rate and its bytes (each input read once, each output written
# once) over the HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# fill levels one 2048-frame request's chunks walk through (K1 timing)
K1_FILLS = (0, 8192, 20000, 32000)
# the shapes phases 12-16 give the kernels: a prompt-guided block is a
# 32-frame chunk (2304 rows) with the prompt's last text segment after it
# (the vision-end token and the 48-token question: 49 rows; a short last
# chunk: 1999 video rows); a spec-decode verify chunk is draft + 1 = 9
# rows; still images are one (1, h, w) grid each: 448x448 (32x32) and
# 644x364 (46x26) in the requests, 36x50 (S = 1800, no multiple of K3's
# 192-row block) beside 32x32 in phase 3
PG_ROWS, PG_SHORT, SPEC_ROWS = 2304 + 49, 1999 + 49, 8 + 1
# phase 17's recapture: video A (256 frames) captures 18449 cache entries
# in a 24576-key budget; its last question is as long as that slack (6127
# ids after the vision-end token), so the hit after the recapture runs one
# text step of 6128 valid rows, padded to 6144, over the 18449 entries in
# the recapture's budget of 32768. Phase 17 checks this shape against the
# prefix the server captured; phase 3 holds K1 to its plain twin at it
RECAP_ROWS, RECAP_VALID, RECAP_CACHE, RECAP_BUDGET = 6144, 6128, 18449, 32768
IMAGE_GRIDS = [(1, 32, 32), (1, 46, 26)]
IMAGE_K3_GRIDS = [(32, 32), (36, 50)]
SAMPLED_BATCH_FRAMES = (64, 128, 256)  # phase 16's sampled generate_batch
# speculative decode against vanilla greedy on the same prefill: the verify
# chunk (K1) and the s = 1 decode round differently, so tokens may part at
# near-ties (reference engine.py:364-368); the bound is the token agreement
# tools/gate_serve_decode_stage.py:135 requires of two decode paths
SPEC_MIN_AGREEMENT = 0.7
# phases 17-18: the online server and the HTTP front end over SERVE_KW.
# Every wait on a thread, future or socket is bounded by WAIT_S. The served
# streams are held to generate(prefix=...) of the same question by token
# agreement, the bound tools/gate_serve_decode_stage.py uses (phase 16 read
# 0.969-1.0 for the server against sequential decode). HTTP_FRAMES: JPEG
# frames written for the HTTP phase (448x252, sampled at the config's 4 fps)
WAIT_S = 300.0
ONLINE_MIN_AGREEMENT = 0.9
HTTP_FRAMES = 64
# phase 22: LLaVA-Video-7B under the published Video-MME config (its 1024
# frames cut to --llava-frames for time). A video chunk is 32 frames x 196
# tokens = 6272 rows; the span's newline token is a last chunk of one row.
# Phase 3 holds K1 to its plain twin at the fill levels a 256-frame request
# walks through (~4993 entries kept a chunk) and times it at 20000
LLAVA_YAML = "configs/llava_video/retake_llava-video_videomme.yaml"
LLAVA_ROWS, LLAVA_BUDGET = 32 * 196, 40960
LLAVA_K1_CASES = [(0, LLAVA_ROWS), (20000, LLAVA_ROWS), (34951, LLAVA_ROWS), (39944, 1)]
LLAVA_K1_TIMED = 20000
# phase 22's kernel path against the plain arms at 64 frames (bf16, 7B
# random weights): the first logits within 2% of the largest logit (first
# H100 reading 0.0134 against "xla") and phase 6's share of kept entries in
# common (first reading 0.9194: 37% of each 6272-row chunk is evicted, and
# near-equal column sums swap between the kernel and plain roundings)
LLAVA_REL_LOGIT_TOL = 0.02
LLAVA_MIN_KEPT = E2E_MIN_KEPT_AGREEMENT
# phase 23: the eval runner under the published serving config (W8A8, int8
# KV, eval_batch_size 4) on 2B. A synthetic Video-MME benchmark of
# EVAL_VIDEOS frame directories of EVAL_FRAMES 448x252 JPEGs, sampled whole
# (the config's 4 fps over --video_frame_extraction_fps 4), EVAL_QUESTIONS
# questions each. 512 frames are 36864 video tokens, above the config's
# max_input_length of 32000, so PivotKV (K2) evicts in every video chunk (at
# 256 frames it would not run). The host pipeline is timed on the videos'
# frames in one directory (symlinks). Reuse against inline: the same samples
# in the same batches, and generate(prefix=) is token-exact (or raises
# PrefixMismatch), so every sample's tokens must be equal. The CLI's two
# processes share the card and take the first MULTI_VIDEOS videos (a sample
# a rank)
SERVING_YAML = "configs/qwen2_vl/retake_qwen2-vl_videomme_tpu_serving.yaml"
EVAL_VIDEOS, EVAL_FRAMES, EVAL_QUESTIONS, EVAL_WORKERS = 4, 512, 2, 2
MULTI_VIDEOS = 1
HOST_FRAMES = EVAL_VIDEOS * EVAL_FRAMES
# cut for time (phase 25's room): the in-process runs (inline, resume,
# reuse) take the first EVAL_RUN_VIDEOS videos, and every eval run decodes
# EVAL_TOKENS tokens a sample (the config's 128 took 8.2 s a batch of 4,
# PERF.md §5); all EVAL_VIDEOS videos' frames still feed the host pipeline
EVAL_RUN_VIDEOS, EVAL_TOKENS = 2, 16
# the native patchify against the numpy path (tests/test_native.py's bound:
# the native pass folds 1/255 and 1/std into one factor, ~5e-7 apart on the CPU)
NATIVE_PATCH_TOL = 1e-5
# phase 24: tensor parallelism over TP_SIZE ranks, processes spawned from
# this script (gloo on one card, NCCL on a card each when the machine has
# TP_SIZE), each rank on its half of the heads. The local shapes its
# kernels run at, and the 2B's at tp = 2, are checked in phase 3:
# (KV, G, S, int8 cache, path) for K1 / K1-int8 and K2 on the same q / k,
# (KV, G, int8, path) for K4 / K4-int8
TP_SIZE = 2
TP_K1_CASES = [(2, 7, LLAVA_ROWS, False, "24 llava (LLaVA-Video-7B at tp = 2)"),
               (1, 6, 2304, False, "2B at tp = 2"),
               (2, 7, 2304, True, "24 request (7B serving config at tp = 2)")]
TP_K4_CASES = [(2, 7, True, "24 server (7B serving config at tp = 2)"),
               (1, 6, False, "2B at tp = 2"),
               (2, 7, False, "24 llava generate_batch (LLaVA-Video-7B at tp = 2)")]
# the TP server serves these of SERVE_REQUESTS (64, 64 and 128 frames
# arriving at 0, 1 and 2 s): the 512-, 256- and first 128-frame requests are
# cut for time (two ranks on one card pass every all-reduce through host
# memory: four requests took 56-93 s on an NVIDIA H100 80GB HBM3 at 700 W,
# PERF.md)
TP_SERVE = (1, 4, 5)
TP_LLAVA_FRAMES = 64
TP_LLAVA_BATCH = (64, 64)  # generate_batch frames (seeds seed + 30 + i)
# the served streams against phase 11's for the same requests: the token
# agreement tools/gate_serve_decode_stage.py:135 requires of two decode paths
TP_MIN_AGREEMENT = 0.7
# (a)'s first logits against tp = 1 (phase 10): the W8A8 prefill under TP is
# exact (global row absmax, int32 sums) and K2's head sums differ from
# tp = 1 only in their order, so the ranks' first logits are those of one
# card up to that rounding (rel 0.0000 to 4 decimals on an NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md); a broken collective moves them by O(1).
# Tighter than phase 10's E2E7_REL_LOGIT_TOL, which bounds kernel vs plain.
TP_REL_LOGIT_TOL = 1e-3
TP_TIMEOUT_S = 600.0  # both ranks' wall, start-up included
# (d): online serving and HTTP on the ranks' 7B engines. Rank 0 submits
# from two threads at their arrival times the TP_D_SUBMIT requests of (b)
# again (one, for time), a 64-frame keyed video asked twice (a miss, then a
# vision-feature and a prefix hit), a request with deadline_s 0 and a
# malformed one; then HTTP over
# HTTP_FRAMES JPEG frames: a miss and two prefix hits. Every request of (d)
# decodes TP_D_TOKENS tokens, for time (host-bound TP decode is 0.27-0.46
# s a token over gloo on one card, PERF.md); (b)'s requests are held to the
# first TP_D_TOKENS of (b)'s streams
TP_D_SUBMIT = [(0, 0, 0.0)]  # (thread, index into TP_SERVE, at s)
TP_D_TOKENS = 8
# phase 25: the gate's inputs: a GATE_FRAMES-frame 448x252 JPEG directory as
# --video, and a Video-MME slice of GATE_SAMPLES questions about one
# GATE_VIDEOMME_FRAMES-frame video (36864 video tokens, past the config's
# max_input_length 32000, so PivotKV runs K2), both read at extraction fps 4
# (every frame sampled); the quant stage at GATE_QUANT_FRAMES frames; every
# stage decodes GATE_TOKENS tokens an answer (the configs' 128 would take
# ~6 s a request at ~48 ms a token, PERF.md), in this process and in the
# gate's own processes
GATE_FRAMES, GATE_VIDEOMME_FRAMES, GATE_SAMPLES, GATE_QUANT_FRAMES = 64, 512, 2, 64
GATE_TOKENS = 8
GATE_KEYS = ("demo", "quant", "spec_parity", "prefix_parity", "http_golden",
             "serve_decode_parity", "videomme_slice", "pass")
GATE_CONFIGS = ("configs/retake_demo.yaml", "configs/qwen2_vl/retake_qwen2-vl_videomme.yaml")
# the JAX stage's tiny-mode bar for the plain and K4 serving streams
# (tools/gate_serve_decode_stage.py:135): random weights sit at near-ties
GATE_MIN_AGREEMENT = 0.7
# cal_ttft: the reference protocol at TTFT_FRAMES frames, TTFT_RUNS runs
# (the first discarded), TPOT over TPOT_TOKENS tokens
TTFT_FRAMES, TTFT_RUNS, TPOT_TOKENS = 512, 3, 64
GATE_TIMEOUT_S = 600  # the gate process's wall (~200-300 s on the H100, PERF.md §6)
# reference points of earlier runs on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md): phase 19's "flash" TTFT at 512 frames before the attention
# window and the "pallas" warm decode of 15 tokens
FLASH_TTFT_BEFORE_S = 13.30
DECODE_15_BEFORE_S = 0.904


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


def bound(flops: float, nbytes: float) -> tuple:
    """(least ms on the card, "operations" or "bytes")."""
    t_ops, t_bytes = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def with_bound(record: dict, flops: float, nbytes: float, library_ms=None, **extra) -> dict:
    """A kernels-line record with its bound, its share of it and the
    library call's time (None where no single PyTorch call computes it)."""
    b, by = bound(flops, nbytes)
    return dict(record, bound_ms=b, bound_by=by, bound_share=b / record["ms"],
                library_ms=library_ms, **extra)


def k1_work(heads, kv, s, d, cache_len, valid_len, int8) -> tuple:
    """FLOPs and bytes K1 needs on these inputs: QK^T and PV (4 * d per
    live (row, key) pair) over the cache prefix and the chunk's live pairs
    (row i sees j <= i with j < valid_len, and itself); q, the cache
    prefix, the chunk's K/V (int8: 1 byte + its share of the f32 scales)
    and the output once."""
    vl = min(valid_len, s)
    pairs = s * cache_len + vl * (vl + 1) // 2 + (s - vl) * (vl + 1)
    per_row = 2 * d + 8 if int8 else 4 * d
    return 4 * d * heads * pairs, 4 * heads * s * d + kv * (cache_len + s) * per_row


def sdpa_call(q, kc, vc, kn, vn, cache_len: int, valid_len: int):
    """One F.scaled_dot_product_attention call computing K1's function:
    K/V concatenated to [KV, cache_len + S, D] and the boolean mask built
    here, outside any timed region. Returns the call and the backend
    PyTorch's dispatcher picks for it."""
    import torch.nn.functional as F

    s, dev = q.shape[1], q.device
    k = torch.cat([kc[:, :cache_len], kn], dim=1)[None]
    v = torch.cat([vc[:, :cache_len], vn], dim=1)[None]
    i = torch.arange(s, device=dev)[:, None]
    jc = torch.arange(cache_len + s, device=dev)[None, :] - cache_len
    mask = (jc < 0) | ((jc <= i) & ((jc < valid_len) | (jc == i)))
    q4 = q[None]
    try:
        names = {0: "math", 1: "flash", 2: "efficient", 3: "cudnn"}
        choice = torch._fused_sdp_choice(q4, k, v, mask, 0.0, False, enable_gqa=True)
        backend = names.get(int(choice), str(choice))
    except (AttributeError, RuntimeError, TypeError) as e:  # private API: name only
        backend = f"unknown ({type(e).__name__})"
    return (lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask, enable_gqa=True),
            backend)


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

    # K1: 2B heads (12 q / 2 kv, D=128), S=2304, budget 40960: error at
    # cache 0 and 20000 with a full and a short chunk; time, TFLOP/s and
    # SDPA's time at the fill levels K1_FILLS
    kv, g, s, d, budget = 2, 6, 2304, 128, 40960
    q = bf16(gen, (kv * g, s, d), dev)
    kc, vc = bf16(gen, (kv, budget, d), dev), bf16(gen, (kv, budget, d), dev)
    kn, vn = bf16(gen, (kv, s, d), dev), bf16(gen, (kv, s, d), dev)
    k1 = flash_prefill.flash_prefill_attention
    worst = 0.0
    for cache_len in (0, 20000):
        for valid_len in (2304, 1999):
            cl, vl = i32(cache_len), i32(valid_len)
            got, again = k1(q, kc, vc, cl, kn, vn, vl), k1(q, kc, vc, cl, kn, vn, vl)
            want = flash_prefill.flash_prefill_attention_plain(q, kc, vc, cl, kn, vn, vl)
            torch.cuda.synchronize()
            check(torch.equal(got, again), "K1 not bitwise repeatable")
            err, tol = max_err(got, want), bf16_tol(want)
            worst = max(worst, err)
            log(f"K1 cache_len={cache_len} valid_len={valid_len}: max|out| "
                f"{want.float().abs().max().item():.3e} max_abs_err {err:.3e} (tol {tol:.3e})")
            check(err <= tol, ("K1", cache_len, valid_len, err, tol))
    del got, again, want
    fills = {}
    for cache_len in K1_FILLS:
        cl, vl = i32(cache_len), i32(s)
        t_k = cuda_ms(lambda: k1(q, kc, vc, cl, kn, vn, vl), 10)
        lib, backend = sdpa_call(q, kc, vc, kn, vn, cache_len, s)
        t_l = cuda_ms(lib, 10)
        del lib
        flops, nbytes = k1_work(kv * g, kv, s, d, cache_len, s, False)
        fills[cache_len] = (t_k, t_l, flops, nbytes)
        log(f"K1 fill {cache_len}: kernel {t_k:.3f} ms = {flops / t_k / 1e9:.1f} TFLOP/s "
            f"({100 * bound(flops, nbytes)[0] / t_k:.1f}% of bound); SDPA ({backend}) "
            f"{t_l:.3f} ms = {flops / t_l / 1e9:.1f} TFLOP/s")
    cl, vl = i32(20000), i32(s)
    t_p = cuda_ms(lambda: flash_prefill.flash_prefill_attention_plain(q, kc, vc, cl, kn, vn, vl), 3, 1)
    t_k, t_l, flops, nbytes = fills[20000]
    log(f"K1 cache_len=20000 valid_len={s}: kernel {t_k:.3f} ms plain {t_p:.3f} ms")
    del kc, vc
    records["K1"] = with_bound(dict(
        name="flash_prefill_attention", route="cuda",
        source="retake_tpu_torch/csrc/flash_prefill.cu",
        replaces="retake_tpu/ops/pallas/flash_prefill.py:182",
        max_abs_err=worst, ms=t_k, plain_ms=t_p,
    ), flops, nbytes, t_l)

    # K2: S=2304 scoring q/k at 2B heads (K1's q and chunk keys) and at 7B
    # heads (28 / 4): error and bitwise repeat at valid_len 2304 and 1999;
    # wrapper time (CUDA events), device time (CUDA-graph replay) and the
    # plain twin's time at 2304; the bound with the exponential term and the
    # two-pass floor beside it
    from retake_tpu_torch.tools.k2_timing import work as k2_work
    from retake_tpu_torch.tools.k4_timing import graph_ms

    k2 = pivot_scores.pivot_score_sums
    k2_plain = pivot_scores.pivot_score_sums_plain
    q7, k7 = bf16(gen, (28, s, d), dev), bf16(gen, (4, s, d), dev)
    k2_rows = {}
    for tag, (qs, ks) in (("2b", (q, kn)), ("7b", (q7, k7))):
        worst = 0.0
        for valid_len in (2304, 1999):
            vl = i32(valid_len)
            got, again = k2(qs, ks, vl), k2(qs, ks, vl)
            want = k2_plain(qs, ks, vl)
            torch.cuda.synchronize()
            check(torch.equal(got, again), ("K2 not bitwise repeatable", tag, valid_len))
            err = max_err(got, want)
            worst = max(worst, err)
            log(f"K2 {tag} heads {qs.shape[0]}/{ks.shape[0]} valid_len={valid_len}: "
                f"max_abs_err {err:.3e} (tol {K2_TOL})")
            check(err <= K2_TOL, ("K2", tag, valid_len, err))
        vl = i32(s)
        t_k, d_k = cuda_ms(lambda: k2(qs, ks, vl), 10), graph_ms(lambda: k2(qs, ks, vl), 50)
        t_p = cuda_ms(lambda: k2_plain(qs, ks, vl), 5)
        w = k2_work(qs.shape[0], ks.shape[0], s, d, s)
        k2_rows[tag] = dict(max_abs_err=worst, ms=t_k, device_ms=d_k, plain_ms=t_p,
                            bound_ms=w["bound_ms"], exp_ms=w["exp_ms"],
                            two_pass_floor_ms=w["floor_ms"])
        log(f"K2 {tag} valid_len={s}: kernel {t_k:.4f} ms (device {d_k:.4f} ms) plain "
            f"{t_p:.3f} ms; bound {w['bound_ms']:.4f} ms ({w['bound_by']}), exponentials "
            f"{w['exp_ms']:.4f} ms a pass, two-pass floor {w['floor_ms']:.4f} ms")
    del got, again, want, q7, k7
    # QK^T over the valid (row, key) square once; q, k in, [KV, S] f32 out
    h = kv * g
    r2 = k2_rows["2b"]
    records["K2"] = with_bound(dict(
        name="pivot_score_sums", route="cuda",
        source="retake_tpu_torch/csrc/pivot_scores.cu",
        replaces="retake_tpu/ops/pallas/pivot_scores.py:87",
        max_abs_err=max(r["max_abs_err"] for r in k2_rows.values()), ms=r2["ms"],
        device_ms=r2["device_ms"], plain_ms=r2["plain_ms"],
    ), 2 * d * h * s * s, 2 * h * s * d + 2 * kv * s * d + 4 * kv * s,
        exp_ms=r2["exp_ms"], two_pass_floor_ms=r2["two_pass_floor_ms"], heads_7b=k2_rows["7b"])
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
        got, again = k3(qkv, cos, sin), k3(qkv, cos, sin)
        want = vit_attention.vit_attention_qkv_plain(qkv, cos, sin)
        torch.cuda.synchronize()
        check(torch.equal(got, again), "K3 not bitwise repeatable")
        err, tol = max_err(got, want), bf16_tol(want)
        worst = max(worst, err)
        log(f"K3 T={t} S={gh * gw}: max|out| {want.float().abs().max().item():.3e} "
            f"max_abs_err {err:.3e} (tol {tol:.3e})")
        check(err <= tol, ("K3", t, gh * gw, err, tol))
    t_k = cuda_ms(lambda: k3(qkv, cos, sin), 10)
    t_p = cuda_ms(lambda: vit_attention.vit_attention_qkv_plain(qkv, cos, sin), 3, 1)
    # the library yardstick: SDPA on q / k rotated beforehand (attention
    # only, rotary excluded)
    import torch.nn.functional as F

    q3, k3_, v3 = qkv.unbind(dim=3)  # [T, S, N, D]
    q3, k3_ = vit_attention._rope_fp32(q3, cos, sin), vit_attention._rope_fp32(k3_, cos, sin)
    q3, k3_, v3 = (x.transpose(1, 2).contiguous() for x in (q3, k3_, v3))  # [T, N, S, D]
    t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q3, k3_, v3), 10)
    t3, s3, n3, _, d3 = qkv.shape
    log(f"K3 T=128: kernel {t_k:.3f} ms plain {t_p:.3f} ms; SDPA on pre-rotated q/k "
        f"{t_l:.3f} ms")
    records["K3"] = with_bound(dict(
        name="vit_attention_qkv", route="cuda",
        source="retake_tpu_torch/csrc/vit_attention.cu",
        replaces="retake_tpu/ops/pallas/vit_attention.py:77",
        max_abs_err=worst, ms=t_k, plain_ms=t_p,
    ), 4 * t3 * n3 * s3 * s3 * d3, 2 * t3 * s3 * n3 * 4 * d3 + 2 * 4 * s3 * d3, t_l,
        library_note="SDPA on q/k rotated beforehand: attention only, rotary excluded")
    del qkv, got, again, want, q3, k3_, v3
    torch.cuda.empty_cache()

    # K4: gap-layout batched decode at the serving shapes of phase 7 (2B
    # heads, 4 slots, the 43008-column bucket, a free slot), with and
    # without per-slot dec_start, a 7B-shaped case and a tail S that is no
    # multiple of the 64-column tile. Cases: (B, KV, G, S, final_len,
    # dec_start or None, gap_start, gap_filled)
    from retake_tpu_torch.ops import attention
    from retake_tpu_torch.ops.cuda import decode_gapped

    k4 = decode_gapped.decode_gapped_flash_state
    cases = [
        (4, 2, 6, 43008, [32002, 18498, 4674, 0], [40960, 40976, 40992, 40960], 40960, 64),
        (4, 2, 6, 43008, [32002, 18498, 4674, 0], None, 40960, 64),
        (4, 4, 7, 8192, [8000, 1, 5000, 0], [8100, 8110, 8120, 8100], 8100, 60),
        (2, 2, 6, 1000, [850, 0], [900, 930], 900, 70),
    ]
    worst = 0.0
    for ci, (b, kvh, g, s, fl, ds, gap_start, gap_filled) in enumerate(cases):
        q = bf16(gen, (b, kvh * g, d), dev)
        kc, vc = bf16(gen, (b, kvh, s, d), dev), bf16(gen, (b, kvh, s, d), dev)
        kn, vn = bf16(gen, (b, kvh, d), dev), bf16(gen, (b, kvh, d), dev)
        final_len = i32(fl)
        dec_start = None if ds is None else i32(ds)
        args = (q, kc, vc, final_len, gap_start, gap_filled, kn, vn)
        got = attention.decode_attention_batch_gapped(*args, dec_start=dec_start, impl="pallas")
        want = attention.decode_attention_batch_gapped(*args, dec_start=dec_start, impl="xla")
        dec0 = i32([gap_start] * b) if ds is None else dec_start
        q4 = q.reshape(b, kvh, g, d)
        we = gap_start + gap_filled
        state = k4(q4, kc, vc, final_len, dec0, we)
        again = k4(q4, kc, vc, final_len, dec0, we)
        _, pm, _ = decode_gapped.decode_gapped_flash_state_plain(q4, kc, vc, final_len, dec0, we)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(state, again)), "K4 not bitwise repeatable")
        err, tol = max_err(got, want), bf16_tol(want)
        m_err = max_err(state[1], pm)
        worst = max(worst, err)
        log(f"K4 B={b} KV={kvh} G={g} S={s} dec_start={'per slot' if ds else 'None'}: max|out| "
            f"{want.float().abs().max().item():.3e} max_abs_err {err:.3e} (tol {tol:.3e}), "
            f"m err {m_err:.3e} (tol {K4_M_TOL})")
        check(err <= tol and m_err <= K4_M_TOL, ("K4", ci, err, tol, m_err))
        if ci == 0:
            t_k = cuda_ms(lambda: k4(q4, kc, vc, final_len, dec0, we), 20)
            d_k = graph_ms(lambda: k4(q4, kc, vc, final_len, dec0, we), 50)
            t_p = cuda_ms(lambda: decode_gapped.decode_gapped_flash_state_plain(
                q4, kc, vc, final_len, dec0, we), 5)
            t_ka = cuda_ms(lambda: attention.decode_attention_batch_gapped(
                *args, dec_start=dec_start, impl="pallas"), 20)
            t_pa = cuda_ms(lambda: attention.decode_attention_batch_gapped(
                *args, dec_start=dec_start, impl="xla"), 5)
            live = sum(fl) + sum(we - x for x in ds)
            k4_work = (4 * live * kvh * g * d,  # K/V of the live columns, q, (acc, m, l)
                       4 * live * kvh * d + 2 * b * kvh * g * d + 4 * b * kvh * g * (d + 2))
            log(f"K4 serving case: kernel {t_k:.4f} ms (device {d_k:.4f} ms) plain {t_p:.4f} ms; "
                f"with the merge: "
                f"kernel arm {t_ka:.4f} ms plain arm {t_pa:.4f} ms; live K/V "
                f"{live * kvh * d * 2 * 2 / 1e6:.1f} MB -> {live * kvh * d * 4 / t_k / 1e6:.0f} GB/s")
        del q, kc, vc, kn, vn, got, want, state, again
    records["K4"] = with_bound(dict(
        name="decode_gapped_flash_state", route="cuda",
        source="retake_tpu_torch/csrc/decode_gapped.cu",
        replaces="retake_tpu/ops/pallas/decode_gapped.py:220",
        max_abs_err=worst, ms=t_k, device_ms=d_k, plain_ms=t_p,
    ), *k4_work)
    torch.cuda.empty_cache()


def phase_kernels_int8(dev, records):
    """K1-int8 and K4-int8 against their plain twins at the 7B (and 2B)
    main-path shapes: error, bitwise repeat, CUDA-event medians."""
    from retake_tpu_torch.ops import attention
    from retake_tpu_torch.ops.cuda import decode_gapped, flash_prefill
    from retake_tpu_torch.ops.quantization import quantize_kv_block
    from retake_tpu_torch.tools.k4_timing import graph_ms

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731

    def int8(shape):
        return quantize_kv_block(bf16(gen, shape, dev))

    # K1-int8: int8 cache and pre-quantized chunk (the decoder's single
    # rounding site), S=2304, budget 40960; 7B heads (28 q / 4 kv) and 2B
    # heads (12 q / 2 kv)
    k1 = flash_prefill.flash_prefill_attention
    s, d, budget = 2304, 128, 40960
    worst, ms, err_by_kv = 0.0, {}, {}
    for kv, g in ((4, 7), (2, 6)):
        q = bf16(gen, (kv * g, s, d), dev)
        (kc, kcs), (vc, vcs) = int8((kv, budget, d)), int8((kv, budget, d))
        (kn, kns), (vn, vns) = int8((kv, s, d)), int8((kv, s, d))
        for cache_len in (0, 20000):
            for valid_len in (2304, 1999):
                cl, vl = i32(cache_len), i32(valid_len)
                args = (q, kc, vc, cl, kn, vn, vl, kcs, vcs, (kns, vns))
                got, again = k1(*args), k1(*args)
                want = flash_prefill.flash_prefill_attention_plain(*args)
                torch.cuda.synchronize()
                check(torch.equal(got, again), "K1-int8 not bitwise repeatable")
                err, tol = max_err(got, want), bf16_tol(want)
                worst = max(worst, err)
                err_by_kv[kv] = max(err_by_kv.get(kv, 0.0), err)
                log(f"K1-int8 heads {kv * g}/{kv} cache_len={cache_len} valid_len={valid_len}: "
                    f"max|out| {want.float().abs().max().item():.3e} max_abs_err {err:.3e} "
                    f"(tol {tol:.3e})")
                check(err <= tol, ("K1-int8", kv, cache_len, valid_len, err, tol))
        del got, again, want
        # time at the fill levels (7B heads), and the plain twin at 20000
        for cache_len in K1_FILLS if kv == 4 else (20000,):
            args = (q, kc, vc, i32(cache_len), kn, vn, i32(s), kcs, vcs, (kns, vns))
            t_k = cuda_ms(lambda: k1(*args), 10)
            flops, nbytes = k1_work(kv * g, kv, s, d, cache_len, s, True)
            ms[(kv, cache_len)] = (t_k, flops, nbytes)
            log(f"K1-int8 heads {kv * g}/{kv} fill {cache_len}: kernel {t_k:.3f} ms = "
                f"{flops / t_k / 1e9:.1f} TFLOP/s ({100 * bound(flops, nbytes)[0] / t_k:.1f}% "
                f"of bound)")
        args = (q, kc, vc, i32(20000), kn, vn, i32(s), kcs, vcs, (kns, vns))
        t_p = cuda_ms(lambda: flash_prefill.flash_prefill_attention_plain(*args), 3, 1)
        ms[(kv, "plain")] = t_p
        log(f"K1-int8 heads {kv * g}/{kv} cache_len=20000: kernel {ms[(kv, 20000)][0]:.3f} ms "
            f"plain {t_p:.3f} ms")
        del q, kc, vc, kn, vn
        torch.cuda.empty_cache()
    t_k, flops, nbytes = ms[(4, 20000)]
    # no single PyTorch call dequantizes per-key int8 K/V and attends
    records["K1-int8"] = with_bound(dict(
        name="flash_prefill_attention_int8", route="cuda",
        source="retake_tpu_torch/csrc/flash_prefill.cu",
        replaces="retake_tpu/ops/pallas/flash_prefill.py:182",
        max_abs_err=worst, ms=t_k, plain_ms=ms[(4, "plain")],
    ), flops, nbytes)
    # 2B heads: the shape of phase 23's eval under the serving config
    t_k, flops, nbytes = ms[(2, 20000)]
    b, by = bound(flops, nbytes)
    records["K1-int8"]["new_shapes"] = [dict(
        path="23 eval (2B heads 12/2)", s=s, cache_len=20000, max_abs_err=err_by_kv[2],
        ms=t_k, plain_ms=ms[(2, "plain")], bound_ms=b, bound_by=by, library_ms=None)]

    # K4-int8 at the 7B serving shape: 4 slots, 4 KV heads, G=7, the
    # 43008-column bucket, mixed live columns; the second case has an
    # all-dead slot (its decode region starts at the write pointer). Cases:
    # (final_len, dec_start or None, gap_start, gap_filled)
    k4 = decode_gapped.decode_gapped_flash_state
    b, kvh, g, s = 4, 4, 7, 43008
    cases = [([32002, 18498, 4674, 20000], None, 40960, 64),
             ([32002, 18498, 4674, 0], [40960, 40976, 40992, 41024], 40960, 64)]
    q = bf16(gen, (b, kvh * g, d), dev)
    (kc, ks), (vc, vs) = int8((b, kvh, s, d)), int8((b, kvh, s, d))
    kn, vn = bf16(gen, (b, kvh, d), dev), bf16(gen, (b, kvh, d), dev)
    q4 = q.reshape(b, kvh, g, d)
    worst = 0.0
    for ci, (fl, ds, gap_start, gap_filled) in enumerate(cases):
        final_len = i32(fl)
        dec_start = None if ds is None else i32(ds)
        dec0 = i32([gap_start] * b) if ds is None else dec_start
        we = gap_start + gap_filled
        args = (q, kc, vc, final_len, gap_start, gap_filled, kn, vn, ks, vs)
        got = attention.decode_attention_batch_gapped(*args, dec_start=dec_start, impl="pallas")
        want = attention.decode_attention_batch_gapped(*args, dec_start=dec_start, impl="xla")
        sargs = (q4, kc, vc, final_len, dec0, we, ks, vs)
        state, again = k4(*sargs), k4(*sargs)
        _, pm, pl = decode_gapped.decode_gapped_flash_state_plain(*sargs)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(state, again)), "K4-int8 not bitwise repeatable")
        dead = pl == 0
        check(torch.equal(dead, state[2] == 0) and bool((state[1][dead] == decode_gapped.NEG_INF).all()),
              "K4-int8 empty state")
        err, tol = max_err(got, want), bf16_tol(want)
        m_err = max_err(state[1][~dead], pm[~dead])
        worst = max(worst, err)
        log(f"K4-int8 B={b} KV={kvh} G={g} S={s} dec_start={'per slot' if ds else 'None'}: "
            f"max|out| {want.float().abs().max().item():.3e} max_abs_err {err:.3e} (tol {tol:.3e}), "
            f"m err {m_err:.3e} (tol {K4_M_TOL}), dead (slot, head) rows {int(dead.sum())}")
        check(err <= tol and m_err <= K4_M_TOL, ("K4-int8", ci, err, tol, m_err))
        if ci == 0:
            t_k = cuda_ms(lambda: k4(*sargs), 20)
            d_k = graph_ms(lambda: k4(*sargs), 50)
            t_p = cuda_ms(lambda: decode_gapped.decode_gapped_flash_state_plain(*sargs), 5)
            live = sum(fl) + b * gap_filled
            k4_work = (4 * live * kvh * g * d,  # int8 K/V + scales, q, (acc, m, l)
                       live * kvh * (2 * d + 8) + 2 * b * kvh * g * d + 4 * b * kvh * g * (d + 2))
            log(f"K4-int8 serving case: kernel {t_k:.4f} ms (device {d_k:.4f} ms) plain "
                f"{t_p:.4f} ms; live K/V "
                f"{live * kvh * (2 * d + 8) / 1e6:.1f} MB -> "
                f"{live * kvh * (2 * d + 8) / t_k / 1e6:.0f} GB/s")
    records["K4-int8"] = with_bound(dict(
        name="decode_gapped_flash_state_int8", route="cuda",
        source="retake_tpu_torch/csrc/decode_gapped.cu",
        replaces="retake_tpu/ops/pallas/decode_gapped.py:220",
        max_abs_err=worst, ms=t_k, device_ms=d_k, plain_ms=t_p,
    ), *k4_work)
    del q, kc, vc, ks, vs, state, again, got, want
    torch.cuda.empty_cache()


def profile_run(fn, what: str):
    """``fn()`` under torch.profiler: kernels by device time, busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    # device-side events, minus the "Command Buffer Full" marker (the host
    # waiting for queue room, not device work)
    kern = sorted((e for e in avgs if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("Command Buffer")),
                  key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    log(f"[p] profiled {what}: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%, profiler on)")
    for e in kern[:25]:
        log(f"[p]   {e.self_device_time_total / 1e3:10.1f} ms  x{e.count:<6d} {e.key[:90]}")
    # the port's kernels by name (K2 is three kernels a call; K1 and K4
    # both modes)
    fam = {key: sum(e.self_device_time_total for e in kern if any(n in e.key for n in names))
           for key, names in (("K1", ("flash_prefill_kernel",)),
                              ("K2", ("row_stats_kernel", "col_sums_kernel", "::merge_kernel")),
                              ("K3", ("vit_attention_kernel",)),
                              ("K4", ("decode_gapped_kernel",)))}
    log("[p]   port kernels: " + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in fam.items()))


def compressing_64(rd: dict) -> dict:
    """``rd`` with PivotKV compressing a 64-frame request (max_input_length
    below its ~4700 tokens)."""
    rd = json.loads(json.dumps(rd))
    rd["longvideo_kwargs"]["kvcache_compression_kwargs"]["max_input_length"] = 3000
    return rd


def all_kernels():
    """Every kernel wrapper (one per mode) by its record key."""
    from retake_tpu_torch.ops.cuda import decode_gapped, flash_prefill, pivot_scores, vit_attention

    return {"K1": flash_prefill.flash_prefill_attention,
            "K1-int8": flash_prefill.flash_prefill_attention_int8,
            "K2": pivot_scores.pivot_score_sums, "K3": vit_attention.vit_attention_qkv,
            "K4": decode_gapped.decode_gapped_flash_state,
            "K4-int8": decode_gapped.decode_gapped_flash_state_int8}


def zero_counts():
    for fn in all_kernels().values():
        fn.launches = 0


def read_counts() -> dict:
    return {key: fn.launches for key, fn in all_kernels().items()}


def phase_serve(cfg, model, rt, dev, seed: int, tag: str = "7") -> tuple:
    """ContinuousServer.run over SERVE_REQUESTS with decode_attn_impl left at
    "auto"; returns the kernels' launch counts of this run (keyed K1..K4-int8)
    and each request with its served tokens.
    With an int8 KV cache the int8 modes of K1 and K4 must run, the bf16
    ones not at all."""
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine
    from retake_tpu_torch.runtime.serve import ContinuousServer

    int8 = rt.kv_cache_dtype == "int8"
    engine = Qwen2VLEngine(cfg, model, rt, device=dev)
    server = ContinuousServer(engine, **SERVE_KW)
    check(server.decode_attn_impl == "pallas", ("decode_attn_impl auto ->", server.decode_attn_impl))
    reqs, budgets = [], []
    for i, (frames, _, own_max) in enumerate(SERVE_REQUESTS):
        ids, patches, grid = build_request(cfg, frames, dev, seed + i)
        req = dict(input_ids=ids, pixel_values_videos=patches, video_grid_thw=grid)
        if own_max is not None:
            req["max_new_tokens"] = own_max
        reqs.append(req)
        budgets.append(own_max or SERVE_KW["max_new_tokens"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    results = server.run(reqs, arrival_times=[a for _, a, _ in SERVE_REQUESTS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    st = server.stats
    log(f"[{tag}] served {len(results)} requests in {wall:.3f} s; stats {json.dumps(st)}")
    log(f"[{tag}] launches {launches}")
    for r, (frames, arrival, _), budget in zip(results, SERVE_REQUESTS, budgets):
        log(f"[{tag}]   req {r.request_id}: {frames} frames, arrival {arrival:.1f} s, prefill start "
            f"{r.prefill_start_s:.3f} s, TTFT {r.ttft_s:.3f} s, finish {r.finish_s:.3f} s, "
            f"{len(r.tokens)}/{budget} tokens {r.tokens[:4].tolist()}")
        check(not r.cancelled and len(r.tokens) == budget, ("tokens", r.request_id, len(r.tokens)))
        check(((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all(), r.tokens)
    check(st["compactions"] >= 1, st)
    # requests 0-3 fill the 4 slots; 4 and 5 can only enter a slot freed by
    # a finished request while the others still decode
    first_free = min(r.finish_s for r in results[:4])
    late = results[4]
    check(late.prefill_start_s >= first_free
          and any(r.finish_s > late.first_token_s for r in results if r is not late),
          ("mid-run admission", first_free, late.prefill_start_s))
    seg = SERVE_KW["segment_steps"]
    k4_want = cfg.num_hidden_layers * seg * st["segments_dispatched"]
    on, off = (("K1-int8", "K2", "K3", "K4-int8"), ("K1", "K4")) if int8 else (
        ("K1", "K2", "K3", "K4"), ("K1-int8", "K4-int8"))
    check(launches[on[3]] == k4_want, (launches, k4_want))
    check(all(launches[k] > 0 for k in on) and all(launches[k] == 0 for k in off), launches)
    if int8:  # the scale planes exist and were compacted with k/v
        check(server.ks_all is not None and server.k_all.dtype == torch.int8, "int8 planes")
    n_dec = sum(len(r.tokens) - 1 for r in results)
    ttft = sorted(r.ttft_s for r in results)
    log(f"[{tag}] served decode: {n_dec} tokens in {wall:.3f} s = {n_dec / wall:.2f} tok/s "
        f"(whole run, prefills included); TTFT p50 {np.percentile(ttft, 50):.3f} s, p95 "
        f"{np.percentile(ttft, 95):.3f} s; peak memory {peak / 2**30:.2f} GiB")
    streams = [(req, r.tokens) for req, r in zip(reqs, results)]
    del server, engine, results
    return launches, streams


def phase_decode_step(cfg, model, rt, dev, seed: int, profile: bool) -> None:
    """Three real prefills (64, 256, 512 frames) gathered into a gap-layout
    cache at the server's bucket; one text.decode_step_batch with K4 and one
    with the plain arm, held to the first-step logits. ``profile``: one more
    K4 step under torch.profiler."""
    from retake_tpu_torch.models.qwen2_vl import text
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine, assemble_gap_cache

    engine = Qwen2VLEngine(cfg, model, rt, device=dev)
    max_new = SERVE_KW["max_new_tokens"]
    states = []
    for i, frames in enumerate((64, 256, 512)):
        ids, patches, grid = build_request(cfg, frames, dev, seed + 10 + i)
        states.append(engine.generate(ids, patches, grid, max_new_tokens=max_new,
                                      _prefill_only=True))
    final_lens = [st.final_len for st in states]
    gap_start = SERVE_KW["prefill_bucket"]
    s_attn = gap_start + 2048
    firsts = [st.first_token_host for st in states]
    pos_rest = torch.tensor([st.decode_pos_base for st in states], dtype=torch.int32).to(dev)
    k_all, v_all, base_t, _, _ = assemble_gap_cache(states, s_attn)
    final_len = torch.tensor(final_lens, dtype=torch.int32).to(dev)
    hidden = text.embed(model, torch.tensor(firsts, dtype=torch.int64).to(dev))
    logits, ms = {}, {}
    for impl in ("pallas", "xla", "xla", "pallas"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h, _, _ = text.decode_step_batch(model, cfg, k_all, v_all, hidden, base_t, pos_rest,
                                         final_len, gap_start, 0, attn_impl=impl)
        out = text.final_logits_batch(model, cfg, h)
        torch.cuda.synchronize()
        ms.setdefault(impl, []).append(1e3 * (time.perf_counter() - t0))
        logits[impl] = out
    a, b = logits["pallas"], logits["xla"]
    check(bool(torch.isfinite(a).all()) and a.shape == (3, cfg.vocab_size), a.shape)
    rel = max_err(a, b) / b.abs().max().item()
    log(f"[8] decode step over prefills {final_lens} (bucket {s_attn}): logits max|diff| "
        f"{max_err(a, b):.4e} (rel {rel:.4f}, bound {E2E_REL_LOGIT_TOL}); step ms (host wall, "
        f"synchronized, 2 each) kernel {ms['pallas']} plain {ms['xla']}")
    check(rel <= E2E_REL_LOGIT_TOL, rel)
    if profile:
        profile_run(lambda: text.final_logits_batch(model, cfg, text.decode_step_batch(
            model, cfg, k_all, v_all, hidden, base_t, pos_rest, final_len, gap_start, 0,
            attn_impl="pallas")[0]), "decode step (K4)")
    del k_all, v_all, states, engine


def phase_request(cfg, model, rd: dict, dev, args, tags, rel_tol, min_kept, ref=None) -> dict:
    """One ReTaKe request through ``Qwen2VLEngine.generate`` at ``--frames``
    with launch counts (phase tags[0]); the same request warm and bit-exact
    (tags[1]); kernel path vs plain path at 64 frames, bounded by
    ``rel_tol`` on the first logits and ``min_kept`` on the entries PivotKV
    kept (tags[2]). Returns the launch counts of the first run; ``ref`` (a
    dict) gets its tokens, first logits and cache positions on the host
    (phase 24's tp = 1 reference)."""
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine, plan_chunks
    from retake_tpu_torch.utils.config import RetakeConfig

    t4, t5, t6 = tags
    rt = RetakeConfig.from_dict(rd)
    int8 = rt.kv_cache_dtype == "int8"
    engine = Qwen2VLEngine(cfg, model, rt, device=dev)
    ids, patches, grid = build_request(cfg, args.frames, dev, args.seed)
    chunk_tokens = engine.get_chunk_tokens(grid[0])
    ratio = rt.compression_ratio_for(len(ids))
    compress = rt.kvcache_compression and ratio < 1.0
    guided = rt.kv.prompt_guided_compression and compress
    plan, final_len, _ = plan_chunks(ids, cfg.video_token_id, chunk_tokens, ratio, compress, guided)
    n_video_chunks = sum(p["kind"] == "video" for p in plan)
    n_vit_chunks = -(-int(grid[0][0]) // rt.frame_chunk_size)
    text_steps = [p["keep"] for p in plan if p["kind"] == "text"]
    question = f", each with the {plan[-1]['valid']}-token question" if guided else ""
    log(f"[{t4}] request: {args.frames} frames, grid {grid[0].tolist()}, {len(ids)} tokens, "
        f"ratio {ratio:.4f}, {len(plan)} prefill steps ({n_video_chunks} video chunks{question}), "
        f"planned cache {final_len} = pre {text_steps[0]} + sum(keep) "
        f"{sum(p['keep'] for p in plan if p['kind'] == 'video')} + post {text_steps[-1]}; "
        f"quantization {rt.quantization}, kv cache "
        f"{rt.kv_cache_dtype or 'bf16'}, W8A8 linears {engine.act_quant and model.int8}")

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = engine.generate(ids, patches, grid, max_new_tokens=MAX_NEW_TOKENS)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    toks = res.tokens
    log(f"[{t4}] tokens {toks.tolist()}")
    log(f"[{t4}] launches {launches}")
    k1, k1_off = ("K1-int8", "K1") if int8 else ("K1", "K1-int8")
    check(len(toks) >= 1 and ((toks >= 0) & (toks < cfg.vocab_size)).all(), toks)
    check(res.cache_fill == res.cache_len == final_len, (res.cache_fill, res.cache_len, final_len))
    check(res.cache.quantized == int8, "KV cache dtype")
    check(launches["K3"] >= cfg.vision.depth * n_vit_chunks, launches)
    check(launches[k1] >= cfg.num_hidden_layers * len(plan) and launches[k1_off] == 0, launches)
    check(launches["K2"] >= cfg.num_hidden_layers * n_video_chunks, launches)
    check(launches["K4"] == launches["K4-int8"] == 0, launches)  # sequential decode: no K4
    check(np.isfinite(res.first_logits).all(), "non-finite first-token logits")
    dec_ms = 1e3 * res.decode_seconds / max(len(toks) - 1, 1)
    log(f"[{t4}] cold: TTFT {res.prefill_seconds:.3f} s, decode {dec_ms:.2f} ms/token over "
        f"{len(toks) - 1} tokens, peak memory {peak / 2**30:.2f} GiB")

    # determinism (warm run, with per-stage timing): the whole request is
    # bit-exact, K2's fixed-order sums included, so PivotKV keeps the same
    # entries and the cache (int8 values and scales) and the first-token
    # logits repeat exactly
    os.environ["RETAKE_PROFILE"] = "1"
    res2 = engine.generate(ids, patches, grid, max_new_tokens=MAX_NEW_TOKENS)
    os.environ.pop("RETAKE_PROFILE")
    n = int(res.cache.length)
    fields = ("k", "v", "pos") + (("k_scale", "v_scale") if int8 else ())
    same = {
        "tokens": np.array_equal(res2.tokens, toks),
        "first_logits": np.array_equal(res2.first_logits, res.first_logits),
        "cache_length": n == int(res2.cache.length),
        **{f"cache_{f}": torch.equal(getattr(res.cache, f)[:, :, :n], getattr(res2.cache, f)[:, :, :n])
           for f in fields},
    }
    log(f"[{t5}] bit-exact repeat: {same}")
    check(all(same.values()), same)
    if ref is not None:  # the entries the prefill kept (decode appends after them)
        ref.update(tokens=toks, first_logits=res.first_logits,
                   pos=res.cache.pos[:, :, :res.cache_fill].cpu().numpy())
    dec_ms2 = 1e3 * res2.decode_seconds / max(len(res2.tokens) - 1, 1)
    log(f"[{t5}] warm (stage timer on): TTFT {res2.prefill_seconds:.3f} s, "
        f"decode {dec_ms2:.2f} ms/token, stages "
        + json.dumps({k: round(v, 4) for k, v in (res2.stages or {}).items()}))
    del res, res2
    if args.profile:
        profile_run(lambda: engine.generate(ids, patches, grid, max_new_tokens=MAX_NEW_TOKENS),
                    f"request ({cfg.hidden_size} wide)")
    del engine, patches
    torch.cuda.empty_cache()

    # kernel path vs plain path, 64 frames, PivotKV compressing every video
    # chunk
    ids6, patches6, grid6 = build_request(cfg, 64, dev, args.seed + 1)
    kernel_vs_plain(cfg, model, compressing_64(rd), dev, t6, "64 frames", rel_tol, min_kept,
                    input_ids=ids6, pixel_values_videos=patches6, video_grid_thw=grid6)
    torch.cuda.empty_cache()
    return launches


def phase_weight_only(cfg, model, dev, seed: int) -> None:
    """The 2B weights quantized on the device (``quantize_llm_int8``) under
    ``quantization: int8``: a 64-frame request's first logits against the
    bf16 model's on the same weights and request."""
    from retake_tpu_torch.models.qwen2_vl import params as params_lib
    from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
    from retake_tpu_torch.ops.quantization import quantize_llm_int8
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine
    from retake_tpu_torch.utils.config import RetakeConfig

    qmodel = Qwen2VLModel(cfg, quantize_llm_int8(params_lib.init_params(cfg, seed=seed, device=dev)))
    check(torch.equal(qmodel.visual.patch_embed.w, model.visual.patch_embed.w), "same weights")
    ids, patches, grid = build_request(cfg, 64, dev, seed + 2)
    out = {}
    for name, m, extra in (("bf16", model, {}), ("int8", qmodel, {"quantization": "int8"})):
        eng = Qwen2VLEngine(cfg, m, RetakeConfig.from_dict(dict(RETAKE_CONFIG, **extra)), device=dev)
        out[name] = eng.generate(ids, patches, grid, max_new_tokens=MAX_NEW_TOKENS)
    a, b = out["int8"].first_logits, out["bf16"].first_logits
    rel = float(np.abs(a - b).max() / np.abs(b).max())
    cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    w8_gb = sum(p.numel() * p.element_size() for p in qmodel.parameters()) / 1e9
    bf_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    dec = {k: 1e3 * r.decode_seconds / max(len(r.tokens) - 1, 1) for k, r in out.items()}
    log(f"[9] weight-only int8 vs bf16 (2B, 64 frames): first logits rel max|diff| {rel:.4f} "
        f"(bound {W8_REL_LOGIT_TOL}), cosine {cos:.5f} (bound {W8_MIN_COSINE}); weights "
        f"{w8_gb:.2f} vs {bf_gb:.2f} GB; decode ms/token int8 {dec['int8']:.2f} bf16 "
        f"{dec['bf16']:.2f}; tokens {out['int8'].tokens[:4].tolist()} / "
        f"{out['bf16'].tokens[:4].tolist()}")
    check(np.isfinite(a).all() and rel <= W8_REL_LOGIT_TOL and cos >= W8_MIN_COSINE, (rel, cos))
    del qmodel, out
    torch.cuda.empty_cache()


def phase_kernels_new_shapes(dev, records):
    """The shapes phases 12-17 give the kernels: K1 and K2 at the
    prompt-guided block (S = 2304 + 49 rows, a full and a short last chunk),
    K1 at a spec-decode verify chunk (S = 9) over a ~32k cache and at phase
    17's recapture text step (S = 6144 over 18449 entries), K3 at T = 1
    for a 448x448 image (S = 1024) and a 36x50 grid (S = 1800, no multiple of
    the kernel's 192-row block). Error against the plain twin, bitwise
    repeat, CUDA-event medians, bound and the library call's time, added to
    each kernel's record under ``new_shapes``."""
    import torch.nn.functional as F

    from retake_tpu_torch.models.qwen2_vl.vision import vision_rotary_tables
    from retake_tpu_torch.ops.cuda import flash_prefill, pivot_scores, vit_attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    kv, g, d, budget = 2, 6, 128, 40960
    h = kv * g
    k1, k1_plain = flash_prefill.flash_prefill_attention, flash_prefill.flash_prefill_attention_plain
    k2, k2_plain = pivot_scores.pivot_score_sums, pivot_scores.pivot_score_sums_plain
    kc, vc = bf16(gen, (kv, budget, d), dev), bf16(gen, (kv, budget, d), dev)
    for key in ("K1", "K2", "K3"):
        records[key]["new_shapes"] = []
    # (what, S, cache budget, (cache_len, valid_len) error cases, the timed case)
    k1_cases = [("prompt-guided block", PG_ROWS, budget, [(0, PG_ROWS), (20000, PG_ROWS),
                                                        (20000, PG_SHORT)], (20000, PG_ROWS)),
                ("spec-decode verify chunk", SPEC_ROWS, budget,
                 [(0, SPEC_ROWS), (31999, SPEC_ROWS), (32000, SPEC_ROWS)], (32000, SPEC_ROWS)),
                ("prefix recapture text step", RECAP_ROWS, RECAP_BUDGET,
                 [(0, RECAP_VALID), (RECAP_CACHE, RECAP_VALID)], (RECAP_CACHE, RECAP_VALID))]
    for what, s, budget_c, cases, (cl_t, vl_t) in k1_cases:
        if kc.shape[1] != budget_c:
            del kc, vc
            kc, vc = bf16(gen, (kv, budget_c, d), dev), bf16(gen, (kv, budget_c, d), dev)
        q = bf16(gen, (h, s, d), dev)
        kn, vn = bf16(gen, (kv, s, d), dev), bf16(gen, (kv, s, d), dev)
        worst = 0.0
        for cache_len, valid_len in cases:
            cl, vl = i32(cache_len), i32(valid_len)
            got, again = k1(q, kc, vc, cl, kn, vn, vl), k1(q, kc, vc, cl, kn, vn, vl)
            want = k1_plain(q, kc, vc, cl, kn, vn, vl)
            torch.cuda.synchronize()
            check(torch.equal(got, again), ("K1 not bitwise repeatable", what, cache_len))
            err, tol = max_err(got, want), bf16_tol(want)
            worst = max(worst, err)
            log(f"K1 {what} S={s} cache_len={cache_len} valid_len={valid_len}: max_abs_err "
                f"{err:.3e} (tol {tol:.3e})")
            check(err <= tol, ("K1", what, cache_len, valid_len, err, tol))
        cl, vl = i32(cl_t), i32(vl_t)
        t_k = cuda_ms(lambda: k1(q, kc, vc, cl, kn, vn, vl), 20)
        t_p = cuda_ms(lambda: k1_plain(q, kc, vc, cl, kn, vn, vl), 3, 1)
        lib, backend = sdpa_call(q, kc, vc, kn, vn, cl_t, vl_t)
        t_l = cuda_ms(lib, 20)
        del lib
        flops, nbytes = k1_work(h, kv, s, d, cl_t, vl_t, False)
        b, by = bound(flops, nbytes)
        log(f"K1 {what} S={s} cache_len={cl_t}: kernel {t_k:.4f} ms plain {t_p:.3f} ms SDPA "
            f"({backend}) {t_l:.4f} ms; bound {b:.4f} ms ({by})")
        records["K1"]["new_shapes"].append(dict(
            path=what, s=s, budget=budget_c, cache_len=cl_t, valid_len=vl_t, max_abs_err=worst,
            ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by, library_ms=t_l,
            library_backend=backend))
        if s == PG_ROWS:  # K2 scores the same block's q / k
            worst = 0.0
            for valid_len in (PG_ROWS, PG_SHORT):
                vl = i32(valid_len)
                got, again, want = k2(q, kn, vl), k2(q, kn, vl), k2_plain(q, kn, vl)
                torch.cuda.synchronize()
                check(torch.equal(got, again), ("K2 not bitwise repeatable", valid_len))
                err = max_err(got, want)
                worst = max(worst, err)
                log(f"K2 {what} S={s} valid_len={valid_len}: max_abs_err {err:.3e} (tol {K2_TOL})")
                check(err <= K2_TOL, ("K2", what, valid_len, err))
            vl = i32(s)
            t_k, t_p = cuda_ms(lambda: k2(q, kn, vl), 20), cuda_ms(lambda: k2_plain(q, kn, vl), 5)
            b, by = bound(2 * d * h * s * s, 2 * h * s * d + 2 * kv * s * d + 4 * kv * s)
            log(f"K2 {what} S={s}: kernel {t_k:.4f} ms plain {t_p:.3f} ms; bound {b:.4f} ms ({by})")
            records["K2"]["new_shapes"].append(dict(
                path=what, s=s, valid_len=s, max_abs_err=worst, ms=t_k, plain_ms=t_p,
                bound_ms=b, bound_by=by, library_ms=None))
        del q, kn, vn, got, again, want
    del kc, vc
    k3, k3_plain = vit_attention.vit_attention_qkv, vit_attention.vit_attention_qkv_plain
    for gh, gw in IMAGE_K3_GRIDS:
        s = gh * gw
        cos_np, sin_np = vision_rotary_tables(gh, gw, 80, 2)
        cos, sin = torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev)
        qkv = bf16(gen, (1, s, 16, 3, 80), dev)
        got, again, want = k3(qkv, cos, sin), k3(qkv, cos, sin), k3_plain(qkv, cos, sin)
        torch.cuda.synchronize()
        check(torch.equal(got, again), ("K3 not bitwise repeatable", s))
        err, tol = max_err(got, want), bf16_tol(want)
        log(f"K3 image T=1 grid {gh}x{gw} S={s}: max_abs_err {err:.3e} (tol {tol:.3e})")
        check(err <= tol, ("K3", s, err, tol))
        t_k, t_p = cuda_ms(lambda: k3(qkv, cos, sin), 20), cuda_ms(lambda: k3_plain(qkv, cos, sin), 5)
        q3, k3_, v3 = qkv.unbind(dim=3)
        q3, k3_ = vit_attention._rope_fp32(q3, cos, sin), vit_attention._rope_fp32(k3_, cos, sin)
        q3, k3_, v3 = (x.transpose(1, 2).contiguous() for x in (q3, k3_, v3))
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q3, k3_, v3), 20)
        b, by = bound(4 * 16 * s * s * 80, 2 * s * 16 * 4 * 80 + 2 * 4 * s * 80)
        log(f"K3 image S={s}: kernel {t_k:.4f} ms plain {t_p:.3f} ms SDPA on pre-rotated q/k "
            f"{t_l:.4f} ms; bound {b:.4f} ms ({by})")
        records["K3"]["new_shapes"].append(dict(
            path=f"image {gh}x{gw}", t=1, s=s, max_abs_err=err, ms=t_k, plain_ms=t_p,
            bound_ms=b, bound_by=by, library_ms=t_l))
        del qkv, got, again, want, q3, k3_, v3
    torch.cuda.empty_cache()


def token_agreement(a, b) -> float:
    """Positions where two streams agree over the longer one's length
    (tools/gate_serve_decode_stage.py's token_agreement)."""
    n = min(len(a), len(b))
    return float(np.sum(np.asarray(a[:n]) == np.asarray(b[:n]))) / max(len(a), len(b), 1)


def kernel_vs_plain(cfg, model, rd, dev, tag, what, rel_tol, min_kept, **request):
    """The request through the kernels (launch counts read around it) and
    through the plain twins: (kernel result, plain result, launches); the
    first logits within ``rel_tol`` (relative to the largest), the
    PivotKV-kept entries in common at least ``min_kept``."""
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine
    from retake_tpu_torch.utils.config import RetakeConfig

    out, launches = {}, None
    for impl in ("pallas", "xla"):
        eng = Qwen2VLEngine(cfg, model, RetakeConfig.from_dict(dict(rd, attn_implementation=impl)),
                            device=dev)
        zero_counts()
        out[impl] = eng.generate(**request, max_new_tokens=MAX_NEW_TOKENS)
        if impl == "pallas":
            launches = read_counts()
    a, b = out["pallas"], out["xla"]
    for r in (a, b):
        check(np.isfinite(r.first_logits).all() and len(r.tokens) >= 1
              and ((r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all(), (what, r.tokens))
        check(r.cache_fill == r.cache_len, (what, r.cache_fill, r.cache_len))
    rel = float(np.abs(a.first_logits - b.first_logits).max() / np.abs(b.first_logits).max())
    check(a.cache_fill == b.cache_fill, (a.cache_fill, b.cache_fill))
    kept = kept_agreement(a.cache, b.cache, a.cache_fill)
    log(f"[{tag}] {what}: {request['input_ids'].shape[0]} tokens, cache {a.cache_fill}, TTFT "
        f"{a.prefill_seconds:.3f} s; launches {launches}; kernel vs plain: first logits rel "
        f"max|diff| {rel:.4f} (bound {rel_tol}), kept entries in common {kept:.4f} (bound "
        f"{min_kept}); tokens {a.tokens[:4].tolist()} / {b.tokens[:4].tolist()}")
    check(rel <= rel_tol and kept >= min_kept, (what, rel, kept))
    return a, b, launches


def phase_images(cfg, model, dev, seed: int) -> dict:
    """An image-only request (two images of different grids) and an image +
    video + image request (64 frames, PivotKV compressing the video span):
    K3 launches once per ViT block per image and per video chunk, kernel
    path vs plain path. Returns the launch counts of the mixed request."""
    m2 = cfg.vision.spatial_merge_size**2
    vs, ve, img = cfg.vision_start_token_id, cfg.vision_end_token_id, cfg.image_token_id
    pixels = random_patches(cfg, sum(t * h * w for t, h, w in IMAGE_GRIDS), dev, seed + 30)
    grids = np.asarray(IMAGE_GRIDS)
    n_img = [t * h * w // m2 for t, h, w in IMAGE_GRIDS]
    ids_v, patches, grid = build_request(cfg, 64, dev, seed + 31)
    pre, video, post = ids_v[:16], ids_v[16:-48], ids_v[-48:]
    spans = [np.array([vs] + [img] * n + [ve]) for n in n_img]
    rd = compressing_64(RETAKE_CONFIG)
    tols = (E2E_REL_LOGIT_TOL, E2E_MIN_KEPT_AGREEMENT)
    depth = cfg.vision.depth
    only = np.concatenate([pre, spans[0], spans[1], post]).astype(np.int64)
    _, _, n = kernel_vs_plain(cfg, model, rd, dev, "13", "image-only request (grids "
                              f"{[list(g) for g in IMAGE_GRIDS]})", *tols, input_ids=only,
                              pixel_values=pixels, image_grid_thw=grids)
    check(n["K3"] == depth * len(IMAGE_GRIDS) and n["K1"] == cfg.num_hidden_layers
          and n["K2"] == 0, n)
    mixed = np.concatenate([pre, spans[0], video, spans[1], post]).astype(np.int64)
    a, _, n = kernel_vs_plain(cfg, model, rd, dev, "13", "image + video (64 frames) + image",
                              *tols, input_ids=mixed, pixel_values=pixels, image_grid_thw=grids,
                              pixel_values_videos=patches, video_grid_thw=grid)
    n_vit = -(-int(grid[0][0]) // rd["longvideo_kwargs"]["frame_chunk_size"])
    check(n["K3"] == depth * (len(IMAGE_GRIDS) + n_vit) and n["K2"] > 0, n)
    check(a.cache_len < len(mixed), ("PivotKV", a.cache_len, len(mixed)))
    torch.cuda.empty_cache()
    return n


def phase_reuse(cfg, model, rd, dev, frames: int, seed: int, tag: str, features: bool) -> None:
    """Three questions about one video: inline ``generate``, then (with
    ``features``) ``generate(video_features=...)`` after one
    ``encode_video``, then ``generate(prefix=...)`` after one
    ``encode_prefix``; tokens and first logits bit-exact against inline,
    no K3 launch when reusing, only the question's K1 launches with a
    prefix; a question with another prompt prefix raises PrefixMismatch."""
    from retake_tpu_torch.runtime.engine import PrefixMismatch, Qwen2VLEngine
    from retake_tpu_torch.utils.config import RetakeConfig

    rt = RetakeConfig.from_dict(rd)
    engine = Qwen2VLEngine(cfg, model, rt, device=dev)
    k1 = "K1-int8" if rt.kv_cache_dtype == "int8" else "K1"
    ids0, patches, grid = build_request(cfg, frames, dev, seed)
    rng = np.random.default_rng(seed + 40)
    questions = [ids0] + [np.concatenate([ids0[:-48], rng.integers(10, 1000, size=48)])
                          for _ in range(2)]
    inline = [engine.generate(q, patches, grid, max_new_tokens=MAX_NEW_TOKENS) for q in questions]

    def held(res, ref, what, i, launches):
        same = (np.array_equal(res.tokens, ref.tokens)
                and np.array_equal(res.first_logits, ref.first_logits))
        log(f"[{tag}] {what} question {i}: TTFT {res.prefill_seconds:.3f} s (inline "
            f"{ref.prefill_seconds:.3f} s), decode {res.decode_seconds:.3f} s; bit-exact vs "
            f"inline {same}; launches {launches}")
        check(same, (what, i, res.tokens[:4], ref.tokens[:4]))

    if features:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = engine.encode_video(patches, grid)
        torch.cuda.synchronize()
        log(f"[{tag}] encode_video ({frames} frames): {time.perf_counter() - t0:.3f} s")
        for i, (q, ref) in enumerate(zip(questions, inline)):
            zero_counts()
            res = engine.generate(q, video_features=feats, max_new_tokens=MAX_NEW_TOKENS)
            n = read_counts()
            held(res, ref, "video_features", i, n)
            check(n["K3"] == 0 and n[k1] > 0, n)
        del feats
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefix = engine.encode_prefix(questions[0], patches, grid, max_new_tokens=MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    log(f"[{tag}] encode_prefix ({frames} frames): {time.perf_counter() - t0:.3f} s, cache "
        f"{prefix.final_len} of budget {prefix.budget} ({'int8' if prefix.cache.quantized else 'bf16'})")
    check(prefix.cache.quantized == (rt.kv_cache_dtype == "int8"), "prefix cache dtype")
    for i, (q, ref) in enumerate(zip(questions, inline)):
        zero_counts()
        res = engine.generate(q, prefix=prefix, max_new_tokens=MAX_NEW_TOKENS)
        n = read_counts()
        held(res, ref, "prefix", i, n)
        check(n[k1] == cfg.num_hidden_layers and n["K2"] == n["K3"] == 0, n)
    bad = questions[1].copy()
    bad[0] += 1
    try:
        engine.generate(bad, prefix=prefix, max_new_tokens=MAX_NEW_TOKENS)
        check(False, "a question with another prompt prefix was not refused")
    except PrefixMismatch as e:
        log(f"[{tag}] another prompt prefix: PrefixMismatch ({e})")
    del prefix, engine, inline
    torch.cuda.empty_cache()


def phase_spec(cfg, model, dev, args) -> tuple:
    """Prompt-lookup speculative decode on the phase-4 request: tokens per
    verify step m / n_it, K1 launches (one per layer per prefill step and
    per verify step), token agreement with vanilla greedy over the same
    prefill (>= SPEC_MIN_AGREEMENT). Returns (the greedy tokens, launches)."""
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine, plan_chunks
    from retake_tpu_torch.utils.config import RetakeConfig

    ids, patches, grid = build_request(cfg, args.frames, dev, args.seed)
    greedy = Qwen2VLEngine(cfg, model, RetakeConfig.from_dict(RETAKE_CONFIG), device=dev).generate(
        ids, patches, grid, max_new_tokens=MAX_NEW_TOKENS)
    rt = RetakeConfig.from_dict(dict(RETAKE_CONFIG, spec_decode=True))
    engine = Qwen2VLEngine(cfg, model, rt, device=dev)
    ratio = rt.compression_ratio_for(len(ids))
    plan, _, _ = plan_chunks(ids, cfg.video_token_id, engine.get_chunk_tokens(grid[0]), ratio,
                             ratio < 1.0)
    zero_counts()
    res = engine.generate(ids, patches, grid, max_new_tokens=MAX_NEW_TOKENS)
    n = read_counts()
    m, n_it = res.spec_steps
    agree = token_agreement(res.tokens, greedy.tokens)
    per = lambda r: 1e3 * r.decode_seconds / max(len(r.tokens) - 1, 1)  # noqa: E731
    log(f"[15] spec decode (ngram {rt.spec_ngram}, draft {rt.spec_draft}): {m} tokens in {n_it} "
        f"verify steps = {m / n_it:.3f} tokens a step; launches {n}; decode {per(res):.2f} "
        f"ms/token vs greedy {per(greedy):.2f}; agreement with greedy {agree:.4f} (bound "
        f"{SPEC_MIN_AGREEMENT}); tokens {res.tokens.tolist()} / {greedy.tokens.tolist()}")
    check(n["K1"] == cfg.num_hidden_layers * (len(plan) + n_it), (n, len(plan), n_it))
    check(np.array_equal(res.first_logits, greedy.first_logits), "spec first logits")
    check(agree >= SPEC_MIN_AGREEMENT, agree)
    del engine
    return greedy.tokens, n


def phase_sampling(cfg, model, dev, args, greedy_tokens) -> tuple:
    """Sampled decode: a seed repeats bit-exactly, temperature 1e-4 gives the
    greedy tokens, top-k 5 with top-p 0.9 runs; sampled generate_batch over
    three requests and the phase-7 server mix with do_sample, each with K4
    launch counts and each request's agreement with its sequential sampled
    run (reported: K4 and the plain sequential decode round differently).
    Returns (batch launches, server launches)."""
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine
    from retake_tpu_torch.utils.config import RetakeConfig

    def engine_for(**kw):
        rd = dict(RETAKE_CONFIG, do_sample=True, **kw)
        return Qwen2VLEngine(cfg, model, RetakeConfig.from_dict(rd), device=dev)

    ids, patches, grid = build_request(cfg, args.frames, dev, args.seed)
    eng = engine_for(seed=7)
    a = eng.generate(ids, patches, grid, max_new_tokens=MAX_NEW_TOKENS)
    b = eng.generate(ids, patches, grid, max_new_tokens=MAX_NEW_TOKENS)
    same = np.array_equal(a.tokens, b.tokens) and np.array_equal(a.first_logits, b.first_logits)
    cold = engine_for(seed=3, temperature=1e-4).generate(ids, patches, grid,
                                                         max_new_tokens=MAX_NEW_TOKENS)
    filt = engine_for(seed=1, top_k=5, top_p=0.9).generate(ids, patches, grid,
                                                           max_new_tokens=MAX_NEW_TOKENS)
    log(f"[16] sampled (seed 7, T 1.0): {a.tokens.tolist()}, repeat bit-exact {same}; T 1e-4: "
        f"{cold.tokens.tolist()} vs greedy {greedy_tokens.tolist()}; top-k 5 top-p 0.9: "
        f"{filt.tokens.tolist()}; decode {1e3 * a.decode_seconds / max(len(a.tokens) - 1, 1):.2f} "
        f"ms/token")
    check(same, "sampled repeat")
    check(np.array_equal(cold.tokens, greedy_tokens), "temperature 1e-4 != greedy")
    check(len(filt.tokens) >= 1 and ((filt.tokens >= 0) & (filt.tokens < cfg.vocab_size)).all(),
          filt.tokens)

    reqs = []
    for i, frames in enumerate(SAMPLED_BATCH_FRAMES):
        r_ids, r_patches, r_grid = build_request(cfg, frames, dev, args.seed + 50 + i)
        reqs.append(dict(input_ids=r_ids, pixel_values_videos=r_patches, video_grid_thw=r_grid))
    seq = [eng.generate(**r, max_new_tokens=MAX_NEW_TOKENS) for r in reqs]
    zero_counts()
    t0 = time.perf_counter()
    batch = eng.generate_batch(reqs, max_new_tokens=MAX_NEW_TOKENS)
    wall = time.perf_counter() - t0
    nb = read_counts()
    agree = [token_agreement(x.tokens, y.tokens) for x, y in zip(batch, seq)]
    log(f"[16] sampled generate_batch ({list(SAMPLED_BATCH_FRAMES)} frames) in {wall:.3f} s: "
        f"launches {nb}; agreement with sequential {agree}")
    steps = max(len(x.tokens) for x in batch) - 1
    check(nb["K4"] >= cfg.num_hidden_layers * steps > 0, (nb, steps))
    check(all(np.array_equal(x.tokens[:1], y.tokens[:1]) for x, y in zip(batch, seq)),
          "sampled first tokens")
    del seq, batch

    serve, streams = phase_serve(cfg, model, eng.retake, dev, args.seed, tag="16")
    agree = []
    for req, toks in streams:
        ref = eng.generate(**{k: v for k, v in req.items() if k != "max_new_tokens"},
                           max_new_tokens=req.get("max_new_tokens", SERVE_KW["max_new_tokens"]))
        agree.append(round(token_agreement(toks, ref.tokens), 4))
    log(f"[16] sampled server: agreement of each request with its sequential run {agree}")
    del eng
    torch.cuda.empty_cache()
    return nb, serve


# ---------- phases 17-20: the rest of serving, the flash arm, MA-LLM


def submit_retrying(handle, req, on_tokens=None, wait_s: float = 300.0):
    """``handle.submit`` that backs off while the backlog is full (a client
    answered 503); returns (future, number of refusals)."""
    import queue

    refused, t_end = 0, time.perf_counter() + wait_s
    while True:
        try:
            return handle.submit(req, on_tokens=on_tokens), refused
        except queue.Full:
            refused += 1
            check(time.perf_counter() < t_end, "backlog never drained")
            time.sleep(0.02)


class Gate:
    """Holds the serving worker inside one engine call (the first after
    ``arm``) until ``release``, so a backlog can be filled on purpose."""

    def __init__(self):
        self.armed, self.entered, self.go = False, threading.Event(), threading.Event()

    def wrap(self, fn):
        def gated(*a, **kw):
            if self.armed:
                self.armed = False
                self.entered.set()
                check(self.go.wait(timeout=WAIT_S), "gate never released")
            return fn(*a, **kw)

        return gated


def spy_calls(engine, record):
    """Wrap the engine's entry points (instance attributes, so the server's
    worker calls the wrappers) to record each call's kind and the kernel
    launches made inside it. Only the worker launches kernels while the
    server runs, so the deltas belong to the call."""
    for name in ("generate", "encode_prefix", "encode_video"):
        fn = getattr(engine, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            if kw.get("_capture_reserve") is not None:  # inside encode_prefix
                return _fn(*a, **kw)
            before = read_counts()
            out = _fn(*a, **kw)
            after = read_counts()
            kind = _name if _name != "generate" else ("prefix" if kw.get("prefix") else "inline")
            record.append((kind, {k: after[k] - before[k] for k in after}))
            return out

        setattr(engine, name, wrapped)


def phase_online(cfg, model, dev, seed: int) -> dict:
    """``start_online`` with both caches: video A (256 frames, key "a") gets
    three questions of 48 ids and, once its prefix is captured, a fourth
    with its own budget of 48 tokens that is as long as the capture's slack,
    so its text step ends past the capture's cache budget (a budget rounds
    up to 8192 and a text step pads to 128, so no budget of a few tens of
    tokens could outgrow it): one recapture. Video B (128 frames, key "b")
    gets two. Two threads submit A's and B's later questions while the
    worker is held in A's first encode, so the backlog fills and one more
    submission meets queue.Full; then a malformed request and one with
    deadline_s 0. Checks the stats, each admission kind's launches (a prefix
    hit: 28 K1, no K2 or K3), K4 in every segment, every budget, the
    recapture's shape against phase 3's K1 case, each hit's first token
    against ``engine.generate(prefix=...)`` and every stream's agreement
    with it."""
    from retake_tpu_torch.utils.config import RetakeConfig

    import queue

    from retake_tpu_torch.runtime.engine import TEXT_BUCKET, Qwen2VLEngine
    from retake_tpu_torch.runtime.serve import ContinuousServer

    engine = Qwen2VLEngine(cfg, model, RetakeConfig.from_dict(RETAKE_CONFIG), device=dev)
    rng = np.random.default_rng(seed + 60)
    ids_a, patches_a, grid_a = build_request(cfg, 256, dev, seed + 61)
    ids_b, patches_b, grid_b = build_request(cfg, 128, dev, seed + 62)

    def question(ids, n=48):
        return np.concatenate([ids[:-48], rng.integers(10, 1000, size=n)]).astype(np.int64)

    qa = [ids_a, question(ids_a), question(ids_a)]
    qb = [ids_b, question(ids_b)]
    req_a = [dict(input_ids=q, pixel_values_videos=patches_a, video_grid_thw=grid_a, video_key="a")
             for q in qa]
    req_b = [dict(input_ids=q, pixel_values_videos=patches_b, video_grid_thw=grid_b, video_key="b")
             for q in qb]
    server = ContinuousServer(engine, **SERVE_KW, vision_cache_slots=2, prefix_cache_slots=2,
                              prefix_reserve_tokens=512)
    calls, gate = [], Gate()
    spy_calls(engine, calls)
    engine.encode_video = gate.wrap(engine.encode_video)
    futs = {}
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    handle = server.start_online(max_queue=4)
    try:
        gate.armed = True
        futs["a0"] = handle.submit(req_a[0])
        check(gate.entered.wait(timeout=WAIT_S), "worker never reached A's encode")

        refused = {}

        def submitter(tag, reqs):
            for i, r in reqs:
                futs[f"{tag}{i}"], refused[f"{tag}{i}"] = submit_retrying(handle, r)

        ta = threading.Thread(target=submitter, args=("a", [(1, req_a[1]), (2, req_a[2])]))
        tb = threading.Thread(target=submitter, args=("b", list(enumerate(req_b))))
        ta.start()
        tb.start()
        t_end = time.perf_counter() + WAIT_S
        while handle._q.qsize() < 4:
            check(time.perf_counter() < t_end, "backlog never filled")
            time.sleep(0.005)
        try:
            handle.submit(dict(req_b[1]))
            full = False
        except queue.Full:
            full = True
        gate.go.set()
        futs["bad"], _ = submit_retrying(handle, {"input_ids": "not-an-array"})
        futs["late"], _ = submit_retrying(handle, dict(req_b[1], deadline_s=0.0))
        # A's long question, sized by the prefix the worker captured (a
        # hit's LRU bump pops the entry for a moment: read until it is there)
        t_end = time.perf_counter() + WAIT_S
        while (vp0 := server._prefix_cache.get("a")) is None:
            check(time.perf_counter() < t_end, "A's prefix never captured")
            time.sleep(0.005)
        steps_a, fill_a, budget_a = len(vp0.plan_sig), vp0.final_len, vp0.budget
        qa.append(question(ids_a, budget_a - fill_a))
        req_a.append(dict(req_a[0], input_ids=qa[3], max_new_tokens=48))
        submitter("a", [(3, req_a[3])])
        for t in (ta, tb):
            t.join(timeout=WAIT_S)
            check(not t.is_alive(), "a submitting thread hung")
        results = {k: f.result(timeout=WAIT_S) for k, f in futs.items()}
    finally:
        gate.go.set()
        handle.close(timeout=WAIT_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    check(not handle._thread.is_alive(), "close() did not join the worker")
    st = dict(server.stats)
    log(f"[17] A's capture: {steps_a} steps, cache {fill_a} of budget {budget_a}; its long "
        f"question {len(qa[3]) - len(ids_a) + 48} ids")
    log(f"[17] online: {len(results)} results in {wall:.3f} s; queue.Full at max_queue 4: {full}; "
        f"refusals while submitting {sum(refused.values())}; stats {json.dumps(st)}")
    log(f"[17] launches {launches}")
    check(full, "no queue.Full at max_queue")
    check(results["bad"].error and results["bad"].cancelled and not len(results["bad"].tokens),
          results["bad"])
    check(results["late"].cancelled and not len(results["late"].tokens) and not results["late"].error,
          results["late"])
    want = {"requests_failed": 1, "requests_rejected_deadline": 1, "requests_admitted": 6,
            "requests_finished": 6, "prefix_cache_misses": 3, "prefix_budget_recaptures": 1,
            "prefix_mismatch_fallbacks": 1, "vision_cache_misses": 2, "vision_cache_hits": 4,
            "prefix_capture_failures": 0, "requests_cancelled": 0}
    check(all(st[k] == v for k, v in want.items()) and st["prefix_cache_hits"] >= 3, (st, want))
    seg = SERVE_KW["segment_steps"]
    check(launches["K4"] == cfg.num_hidden_layers * seg * st["segments_dispatched"] > 0,
          ("K4 in every segment", launches, st["segments_dispatched"]))
    vp_a, steps_b = server._prefix_cache["a"], len(server._prefix_cache["b"].plan_sig)
    recap = (vp_a.final_len, vp_a.budget, len(qa[3]) - vp_a.split)
    check(recap == (RECAP_CACHE, RECAP_BUDGET, RECAP_VALID)
          and -(-RECAP_VALID // TEXT_BUCKET) * TEXT_BUCKET == RECAP_ROWS,
          ("the recapture's text step is not phase 3's K1 case", recap))
    depth, layers = cfg.vision.depth, cfg.num_hidden_layers
    k3_encode = [depth * math.ceil(int(g[0][0]) / RETAKE_CONFIG["longvideo_kwargs"]["frame_chunk_size"])
                 for g in (grid_a, grid_b)]
    kinds = {}
    for kind, n in calls:
        kinds.setdefault(kind, []).append(n)
        if kind == "prefix":  # one 49- or 6128-row text step over the captured cache
            check(n["K1"] == layers and n["K2"] == n["K3"] == 0, (kind, n))
        elif kind == "encode_video":
            check(n["K3"] in k3_encode and n["K1"] == 0, (kind, n))
        elif kind == "encode_prefix":  # the features come from the vision cache
            check(n["K3"] == 0 and n["K1"] in (layers * steps_a, layers * steps_b), (kind, n))
    log("[17] launches per admission kind: " + json.dumps(
        {k: [{x: y for x, y in n.items() if y} for n in v] for k, v in kinds.items()}))
    check(len(kinds.get("prefix", [])) == 6 and len(kinds["encode_video"]) == 2
          and len(kinds["encode_prefix"]) == 3 and "inline" not in kinds,
          {k: len(v) for k, v in kinds.items()})
    for name in ("generate", "encode_prefix", "encode_video"):
        del engine.__dict__[name]

    # each stream against engine.generate(prefix=...) of the same question
    agree, hit_ttft, hit_prefill = {}, [], []
    for tag, reqs in (("a", req_a), ("b", req_b)):
        vp = server._prefix_cache[tag]
        for i, r in enumerate(reqs):
            res = results[f"{tag}{i}"]
            budget = r.get("max_new_tokens", SERVE_KW["max_new_tokens"])
            ref = engine.generate(r["input_ids"], prefix=vp, max_new_tokens=budget)
            check(not res.cancelled and len(res.tokens) == budget, (tag, i, len(res.tokens)))
            check(res.tokens[0] == ref.tokens[0], ("first token vs generate(prefix=)", tag, i))
            agree[f"{tag}{i}"] = round(token_agreement(res.tokens, ref.tokens), 4)
            if i:
                hit_ttft.append(res.ttft_s)
                hit_prefill.append(res.first_token_s - res.prefill_start_s)
    log(f"[17] agreement with generate(prefix=) {agree} (bound {ONLINE_MIN_AGREEMENT}); prefix "
        f"admissions: prefill {min(hit_prefill):.3f}-{max(hit_prefill):.3f} s, TTFT from submission "
        f"{min(hit_ttft):.3f}-{max(hit_ttft):.3f} s (queue wait included); captures: A "
        f"{results['a0'].ttft_s:.3f} s, B {results['b0'].ttft_s:.3f} s")
    check(min(agree.values()) >= ONLINE_MIN_AGREEMENT, agree)
    del server, engine, results, futs, req_a, req_b, patches_a, patches_b
    torch.cuda.empty_cache()
    return launches


class ByteTokenizer:
    """A byte-level stand-in for the Qwen2 tokenizer (none is in the repo):
    byte b is id 1000 + b."""

    def encode(self, s):
        return [1000 + b for b in s.encode("utf-8")]

    def decode(self, ids, **kw):
        return bytes(int(i) - 1000 for i in ids if 1000 <= int(i) < 1256).decode("utf-8", "replace")


def phase_http(cfg, model, dev, seed: int) -> dict:
    """``RetakeHTTPServer`` on 127.0.0.1 (port 0) over the 2B engine with both
    caches: /healthz; a question about a 64-frame JPEG directory (a miss:
    frames loaded, processor, K3, capture), the same question again (a
    prefix hit: no frame loading, no K3, 28 K1) blocking and streamed (the
    stream concatenates to the done event's tokens); /metrics against the
    server's stats; a 503 with Retry-After on a full backlog."""
    from retake_tpu_torch.utils.config import RetakeConfig

    import urllib.error
    import urllib.request

    from retake_tpu_torch.data.processor import Qwen2VLProcessor
    from retake_tpu_torch.eval.synthetic import write_frames
    from retake_tpu_torch.runtime import http_server
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine

    rt = RetakeConfig.from_dict(RETAKE_CONFIG)
    engine = Qwen2VLEngine(cfg, model, rt, device=dev)
    proc = Qwen2VLProcessor(ByteTokenizer(), vision_start_token_id=cfg.vision_start_token_id,
                            vision_end_token_id=cfg.vision_end_token_id,
                            video_token_id=cfg.video_token_id, image_token_id=cfg.image_token_id)
    loads = {"n": 0}
    fetch = http_server.fetch_video

    def counting_fetch(*a, **kw):
        loads["n"] += 1
        return fetch(*a, **kw)

    http_server.fetch_video = counting_fetch
    gate = Gate()
    engine.generate = gate.wrap(engine.generate)
    srv = http_server.RetakeHTTPServer(engine, proc, rt, host="127.0.0.1", port=0, max_queue=1,
                                       **SERVE_KW, vision_cache_slots=2, prefix_cache_slots=2)

    def post(body):
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/generate",
                                     data=json.dumps(body).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            raw, ctype = r.read(), r.headers["Content-Type"]
        wall = time.perf_counter() - t
        if ctype.startswith("text/event-stream"):
            return [json.loads(x[6:]) for x in raw.split(b"\n\n") if x.startswith(b"data: ")], wall
        return json.loads(raw), wall

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=WAIT_S) as r:
            return json.loads(r.read())

    with tempfile.TemporaryDirectory(prefix="retake_frames_") as frames:
        write_frames(frames, HTTP_FRAMES, 448, 252, seed + 70, block=4)
        body = {"question": "What happens in the video? Answer with the option's letter.",
                "video_path": frames, "extraction_fps": rt.sample_fps}
        srv.start()
        try:
            health = get("/healthz")
            check(health["ok"] and health["batch_slots"] == SERVE_KW["batch_slots"], health)
            zero_counts()
            miss, miss_wall = post(body)
            c1 = read_counts()
            hit, hit_wall = post(body)
            c2 = read_counts()
            n_miss, n_hit = c1, {k: c2[k] - c1[k] for k in c2}
            stream, _ = post(dict(body, stream=True))
            metrics, stats = get("/metrics"), dict(srv.server.stats)
            # a full backlog: the worker held in an admission, one request queued
            gate.armed = True
            out = {}

            def background(key):
                out[key] = post({"question": f"Question {key}?"})[0]

            t1 = threading.Thread(target=background, args=("held",))
            t1.start()
            check(gate.entered.wait(timeout=WAIT_S), "worker never reached the held request")
            t2 = threading.Thread(target=background, args=("queued",))
            t2.start()
            t_end = time.perf_counter() + WAIT_S
            while srv.handle._q.qsize() < 1:
                check(time.perf_counter() < t_end, "the HTTP backlog never filled")
                time.sleep(0.005)
            try:
                post({"question": "One too many?"})
                code, retry = 200, None
            except urllib.error.HTTPError as e:
                code, retry = e.code, e.headers["Retry-After"]
            gate.go.set()
            for t in (t1, t2):
                t.join(timeout=WAIT_S)
                check(not t.is_alive(), "an HTTP client thread hung")
        finally:
            gate.go.set()
            srv.shutdown(timeout=WAIT_S)
            http_server.fetch_video = fetch
        torch.cuda.synchronize()
        launches = read_counts()
    check(srv.handle is None and not srv.server._slot_req, "HTTP server did not stop")
    depth, layers = cfg.vision.depth, cfg.num_hidden_layers
    streamed = [t for e in stream if not e.get("done") for t in e["tokens"]]
    done = stream[-1]
    log(f"[18] HTTP: miss (frames loaded, ViT, capture) TTFT {miss['ttft_s']:.3f} s, POST wall "
        f"{miss_wall:.3f} s, launches {n_miss}; prefix hit TTFT {hit['ttft_s']:.3f} s, POST wall "
        f"{hit_wall:.3f} s, launches {n_hit}; frame loads {loads['n']}; stream: {len(stream) - 1} "
        f"chunks; 503 on a full backlog: {code} (Retry-After {retry})")
    check(loads["n"] == 1, ("frame loads", loads))
    check(n_miss["K3"] == depth * math.ceil(HTTP_FRAMES / 2 / 128) and n_miss["K1"] > layers,
          n_miss)
    check(n_hit["K3"] == 0 and n_hit["K1"] == layers and n_hit["K2"] == 0, n_hit)
    budget = SERVE_KW["max_new_tokens"]
    for res in (miss, hit, done):
        check(len(res["tokens"]) == budget and not res["cancelled"] and "error" not in res, res)
    check(streamed == done["tokens"] and done["done"], "stream chunks vs the done event")
    agree = token_agreement(hit["tokens"], done["tokens"])
    check(hit["tokens"][0] == done["tokens"][0] and agree >= ONLINE_MIN_AGREEMENT,
          ("blocking vs streamed", agree))
    check({k: metrics[k] for k in stats} == stats, (metrics, stats))
    check(metrics["prefix_cache_entries"] == 1 and metrics["vision_cache_entries"] == 1, metrics)
    check(code == 503 and retry, (code, retry))
    for key in ("held", "queued"):
        check(len(out[key]["tokens"]) == budget and "error" not in out[key], out[key])
    check(launches["K4"] > 0, launches)
    log(f"[18] blocking vs streamed agreement {agree:.4f}; launches {launches}; metrics "
        f"{json.dumps(metrics)}")
    del srv, engine
    torch.cuda.empty_cache()
    return launches


def phase_flash(cfg, model, dev, args) -> dict:
    """The phase-4 request under ``attn_implementation: "flash"`` (the
    value of configs/retake_demo.yaml) against "pallas" on the same weights
    (first logits, PivotKV-kept entries), no K1 or K2 launch and the K3
    launches of "pallas"; each arm's TTFT in this call; then
    ``generate_batch`` of three requests under "flash", through K4."""
    from retake_tpu_torch.utils.config import RetakeConfig

    from retake_tpu_torch.runtime.engine import Qwen2VLEngine

    ids, patches, grid = build_request(cfg, args.frames, dev, args.seed)
    out, n, ttft = {}, {}, {}
    for impl in ("pallas", "flash", "flash"):
        eng = Qwen2VLEngine(cfg, model, RetakeConfig.from_dict(dict(RETAKE_CONFIG,
                                                               attn_implementation=impl)), device=dev)
        zero_counts()
        res = eng.generate(ids, patches, grid, max_new_tokens=MAX_NEW_TOKENS)
        n[impl] = read_counts()
        ttft.setdefault(impl, []).append(round(res.prefill_seconds, 3))
        out[impl] = res
    a, b = out["flash"], out["pallas"]
    rel = float(np.abs(a.first_logits - b.first_logits).max() / np.abs(b.first_logits).max())
    kept = kept_agreement(a.cache, b.cache, a.cache_fill)
    log(f"[19] with the attention window: flash TTFT {ttft['flash']} s (cold, warm; "
        f"{FLASH_TTFT_BEFORE_S} s before it), pallas decode {b.decode_seconds:.3f} s for "
        f"{len(b.tokens) - 1} tokens ({DECODE_15_BEFORE_S} s for 15 before it)")
    log(f"[19] flash arm, {args.frames} frames: TTFT flash {ttft['flash']} s (cold, warm) vs pallas "
        f"{ttft['pallas']} s (warm); launches flash {n['flash']}, pallas {n['pallas']}; first "
        f"logits rel max|diff| {rel:.4f} (bound {E2E_REL_LOGIT_TOL}), kept entries in common "
        f"{kept:.4f} (bound {E2E_MIN_KEPT_AGREEMENT}); tokens {a.tokens[:4].tolist()} / "
        f"{b.tokens[:4].tolist()}")
    check(np.isfinite(a.first_logits).all() and a.cache_fill == b.cache_fill == a.cache_len,
          (a.cache_fill, b.cache_fill))
    check(n["flash"]["K1"] == n["flash"]["K2"] == 0 and n["flash"]["K3"] == n["pallas"]["K3"] > 0,
          n)
    check(rel <= E2E_REL_LOGIT_TOL and kept >= E2E_MIN_KEPT_AGREEMENT, (rel, kept))
    del out, a, b, patches
    torch.cuda.empty_cache()

    eng = Qwen2VLEngine(cfg, model, RetakeConfig.from_dict(dict(RETAKE_CONFIG,
                                                           attn_implementation="flash")), device=dev)
    reqs = []
    for i, frames in enumerate(SAMPLED_BATCH_FRAMES):
        r_ids, r_patches, r_grid = build_request(cfg, frames, dev, args.seed + 80 + i)
        reqs.append(dict(input_ids=r_ids, pixel_values_videos=r_patches, video_grid_thw=r_grid))
    zero_counts()
    t0 = time.perf_counter()
    batch = eng.generate_batch(reqs, max_new_tokens=MAX_NEW_TOKENS)
    wall = time.perf_counter() - t0
    nb = read_counts()
    steps = max(len(x.tokens) for x in batch) - 1
    log(f"[19] flash generate_batch ({list(SAMPLED_BATCH_FRAMES)} frames) in {wall:.3f} s: "
        f"launches {nb}; tokens {[x.tokens[:4].tolist() for x in batch]}")
    check(nb["K1"] == nb["K2"] == 0 and nb["K4"] >= cfg.num_hidden_layers * steps > 0, (nb, steps))
    check(all(len(x.tokens) >= 1 and np.isfinite(x.first_logits).all() for x in batch), "batch")
    del eng, reqs, batch
    torch.cuda.empty_cache()
    return {"request": n["flash"], "generate_batch": nb}


def phase_malm(cfg, model, dev, seed: int) -> dict:
    """MA-LLM and MA-LLM-hard at 128 frames, compression ratio 0.5, with
    patch_sync off and on: features of shape [tgt * hw, d], a bit-exact
    repeat, one K3 launch per ViT block, a request through them; and
    ``malm_compress``'s time (CUDA events) at 64 merges."""
    from retake_tpu_torch.utils.config import RetakeConfig

    from retake_tpu_torch.ops import dpselect
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine

    ids, patches, grid = build_request(cfg, 128, dev, seed + 90)
    t = int(grid[0][0])
    hw = int(grid[0][1] * grid[0][2]) // cfg.vision.spatial_merge_size**2
    launches = {}
    for method in ("MA-LLM", "MA-LLM-hard"):
        for sync in (False, True):
            rd = json.loads(json.dumps(RETAKE_CONFIG))
            rd["longvideo_kwargs"]["visual_compression_kwargs"].update(
                compression_method=method, compression_ratio=0.5, patch_sync=sync)
            eng = Qwen2VLEngine(cfg, model, RetakeConfig.from_dict(rd), device=dev)
            zero_counts()
            f1 = eng.encode_video(patches, grid)
            n = read_counts()
            f2 = eng.encode_video(patches, grid)
            res = eng.generate(ids, video_features=f1, max_new_tokens=MAX_NEW_TOKENS)
            tag = f"{method} sync={sync}"
            launches[tag] = n
            log(f"[20] {tag}: features {tuple(f1.embeds.shape)} (t {f1.t} -> {f1.tgt}), repeat "
                f"bit-exact {torch.equal(f1.embeds, f2.embeds)}, launches {n}; request: "
                f"{res.input_len} tokens, cache {res.cache_fill}, TTFT {res.prefill_seconds:.3f} s, "
                f"tokens {res.tokens[:4].tolist()}")
            check(f1.tgt == t // 2 and tuple(f1.embeds.shape) == (f1.tgt * hw, cfg.hidden_size),
                  f1.embeds.shape)
            check(torch.equal(f1.embeds, f2.embeds), (tag, "repeat"))
            check(bool(torch.isfinite(f1.embeds.float()).all()), (tag, "finite"))
            check(n["K3"] == cfg.vision.depth * -(-t // 128) and n["K1"] == 0, n)
            check(res.input_len == len(ids) - (t - f1.tgt) * hw and np.isfinite(res.first_logits).all()
                  and res.cache_fill == res.cache_len, (tag, res.input_len, res.cache_fill))
            del f1, f2, res, eng
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 91)
    bank = bf16(gen, (128, hw, cfg.hidden_size), dev)
    ms = {sync: cuda_ms(lambda s=sync: dpselect.malm_compress(bank, 64, sync=s), reps=5)
          for sync in (False, True)}
    log(f"[20] malm_compress, bank {tuple(bank.shape)} bf16 -> 64 frames (64 merges): "
        f"{ms[False]:.3f} ms per patch, {ms[True]:.3f} ms synced (CUDA events, median of 5)")
    del bank, patches
    torch.cuda.empty_cache()
    return launches


def k1_plain_per_kv_head(q, kc, vc, cl, kn, vn, vl, cache_len: int):
    """K1's plain twin one KV head (its G query heads) at a time, over the
    8192-multiple window that covers ``cache_len``: the same function (K1
    reads no key past cache_len), in memory the card has (the whole
    [28, 6272, 47232] fp32 logits of the LLaVA shape would be 33 GB)."""
    from retake_tpu_torch.ops.cuda import flash_prefill

    kv = kc.shape[0]
    g = q.shape[0] // kv
    w = min(kc.shape[1], max(8192, -(-cache_len // 8192) * 8192))
    return torch.cat([
        flash_prefill.flash_prefill_attention_plain(
            q[i * g : (i + 1) * g], kc[i : i + 1, :w], vc[i : i + 1, :w], cl, kn[i : i + 1],
            vn[i : i + 1], vl)
        for i in range(kv)
    ])


def phase_kernels_llava(dev, records):
    """K1 and K2 at the LLaVA-Video-7B prefill of phase 22: 28/4 heads, a
    32-frame chunk of 32 x 196 = 6272 rows over the 40960-key budget at a
    256-frame request's fill levels, and the one-row last chunk of the
    newline token (valid_len 1). Error against the plain twin, bitwise
    repeat, CUDA-event medians, bound and share, and SDPA's time for K1,
    under each record's ``new_shapes``."""
    from retake_tpu_torch.ops.cuda import flash_prefill, pivot_scores

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    kv, g, d, s, budget = 4, 7, 128, LLAVA_ROWS, LLAVA_BUDGET
    h = kv * g
    k1, k2 = flash_prefill.flash_prefill_attention, pivot_scores.pivot_score_sums
    q = bf16(gen, (h, s, d), dev)
    kc, vc = bf16(gen, (kv, budget, d), dev), bf16(gen, (kv, budget, d), dev)
    kn, vn = bf16(gen, (kv, s, d), dev), bf16(gen, (kv, s, d), dev)
    worst = 0.0
    for cache_len, valid_len in LLAVA_K1_CASES:
        cl, vl = i32(cache_len), i32(valid_len)
        got, again = k1(q, kc, vc, cl, kn, vn, vl), k1(q, kc, vc, cl, kn, vn, vl)
        want = k1_plain_per_kv_head(q, kc, vc, cl, kn, vn, vl, cache_len)
        torch.cuda.synchronize()
        check(torch.equal(got, again), ("K1 LLaVA not bitwise repeatable", cache_len))
        err, tol = max_err(got, want), bf16_tol(want)
        worst = max(worst, err)
        log(f"K1 LLaVA-Video-7B chunk S={s} heads {h}/{kv} cache_len={cache_len} "
            f"valid_len={valid_len}: max_abs_err {err:.3e} (tol {tol:.3e})")
        check(err <= tol, ("K1 LLaVA", cache_len, valid_len, err, tol))
        del got, again, want
    cl_t = LLAVA_K1_TIMED
    cl, vl = i32(cl_t), i32(s)
    t_k = cuda_ms(lambda: k1(q, kc, vc, cl, kn, vn, vl), 20)
    t_p = cuda_ms(lambda: k1_plain_per_kv_head(q, kc, vc, cl, kn, vn, vl, cl_t), 3, 1)
    lib, backend = sdpa_call(q, kc, vc, kn, vn, cl_t, s)
    t_l = cuda_ms(lib, 10)
    del lib
    flops, nbytes = k1_work(h, kv, s, d, cl_t, s, False)
    b, by = bound(flops, nbytes)
    log(f"K1 LLaVA-Video-7B chunk S={s} cache_len={cl_t}: kernel {t_k:.4f} ms plain {t_p:.3f} ms "
        f"SDPA ({backend}) {t_l:.4f} ms; bound {b:.4f} ms ({by}), {100 * b / t_k:.1f}% of it")
    records["K1"]["new_shapes"].append(dict(
        path="LLaVA-Video-7B video chunk (28/4 heads)", s=s, budget=budget, cache_len=cl_t,
        valid_len=s, max_abs_err=worst, ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by,
        bound_share=b / t_k, library_ms=t_l, library_backend=backend))
    worst = 0.0
    for valid_len in (s, 1):
        vl = i32(valid_len)
        got, again = k2(q, kn, vl), k2(q, kn, vl)
        want = pivot_scores.pivot_score_sums_plain(q, kn, vl)
        torch.cuda.synchronize()
        check(torch.equal(got, again), ("K2 LLaVA not bitwise repeatable", valid_len))
        err = max_err(got, want)
        worst = max(worst, err)
        log(f"K2 LLaVA-Video-7B chunk S={s} heads {h}/{kv} valid_len={valid_len}: max_abs_err "
            f"{err:.3e} (tol {K2_TOL})")
        check(err <= K2_TOL, ("K2 LLaVA", valid_len, err))
        del got, again, want
    vl = i32(s)
    t_k = cuda_ms(lambda: k2(q, kn, vl), 20)
    t_p = cuda_ms(lambda: pivot_scores.pivot_score_sums_plain(q, kn, vl), 5)
    b, by = bound(2 * d * h * s * s, 2 * h * s * d + 2 * kv * s * d + 4 * kv * s)
    log(f"K2 LLaVA-Video-7B chunk S={s}: kernel {t_k:.4f} ms plain {t_p:.3f} ms; bound {b:.4f} "
        f"ms ({by}), {100 * b / t_k:.1f}% of it")
    records["K2"]["new_shapes"].append(dict(
        path="LLaVA-Video-7B video chunk (28/4 heads)", s=s, valid_len=s, max_abs_err=worst,
        ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by, bound_share=b / t_k, library_ms=None))
    del q, kc, vc, kn, vn
    torch.cuda.empty_cache()


def phase_kernels_tp_shapes(dev, records):
    """The shapes phase 24's ranks give the kernels (tensor parallelism over
    two ranks: each runs its half of the query and KV heads, the GQA group
    unchanged), and the 2B's at tp = 2: K1 at 14/2 heads over a LLaVA chunk
    (S = 6272) and at 6/1 (S = 2304), K1-int8 at 14/2 (S = 2304), K2 at
    14/2 (S = 2304, 6272) and 6/1, K4-int8 at G 7 / KV 2 and K4 at G 6 / KV 1
    and G 7 / KV 2 over the 43008-column serving bucket (B 4). Error against
    the plain twin, bitwise repeat, CUDA-event medians, bound and share, and
    SDPA's time for K1, under each record's ``new_shapes``."""
    from retake_tpu_torch.ops import attention
    from retake_tpu_torch.ops.cuda import decode_gapped, flash_prefill, pivot_scores
    from retake_tpu_torch.ops.quantization import quantize_kv_block

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    d, budget = 128, 40960
    k1, k2 = flash_prefill.flash_prefill_attention, pivot_scores.pivot_score_sums
    for key in ("K1-int8", "K4", "K4-int8"):
        records[key].setdefault("new_shapes", [])
    # K1 (bf16 and int8 cache) and K2: (kv, g, s, int8, path)
    for kv, g, s, int8, path in TP_K1_CASES:
        h = kv * g
        key = "K1-int8" if int8 else "K1"
        q = bf16(gen, (h, s, d), dev)
        kc, vc = bf16(gen, (kv, budget, d), dev), bf16(gen, (kv, budget, d), dev)
        kn, vn = bf16(gen, (kv, s, d), dev), bf16(gen, (kv, s, d), dev)
        extra = ()
        if int8:
            (kc, kcs), (vc, vcs) = quantize_kv_block(kc), quantize_kv_block(vc)
            (kn8, kns), (vn8, vns) = quantize_kv_block(kn), quantize_kv_block(vn)
            extra = (kcs, vcs, (kns, vns))

        def args(cache_len, valid_len):
            return ((q, kc, vc, i32(cache_len), kn8, vn8, i32(valid_len)) + extra if int8
                    else (q, kc, vc, i32(cache_len), kn, vn, i32(valid_len)))

        def plain(cache_len, valid_len):
            if int8:
                return flash_prefill.flash_prefill_attention_plain(*args(cache_len, valid_len))
            a = args(cache_len, valid_len)
            return k1_plain_per_kv_head(*a, cache_len)

        worst = 0.0
        for cache_len, valid_len in ((0, s), (20000, s), (20000, s - 305)):
            got, again = k1(*args(cache_len, valid_len)), k1(*args(cache_len, valid_len))
            want = plain(cache_len, valid_len)
            torch.cuda.synchronize()
            check(torch.equal(got, again), (key, "not bitwise repeatable", path, cache_len))
            err, tol = max_err(got, want), bf16_tol(want)
            worst = max(worst, err)
            log(f"{key} {path} heads {h}/{kv} S={s} cache_len={cache_len} valid_len={valid_len}: "
                f"max_abs_err {err:.3e} (tol {tol:.3e})")
            check(err <= tol, (key, path, cache_len, valid_len, err, tol))
            del got, again, want
        t_k = cuda_ms(lambda: k1(*args(20000, s)), 20)
        t_p = cuda_ms(lambda: plain(20000, s), 3, 1)
        t_l = backend = None
        if not int8:  # no single call dequantizes per-key int8 K/V and attends
            lib, backend = sdpa_call(q, kc, vc, kn, vn, 20000, s)
            t_l = cuda_ms(lib, 10)
            del lib
        flops, nbytes = k1_work(h, kv, s, d, 20000, s, int8)
        b, by = bound(flops, nbytes)
        lib_text = "" if t_l is None else f" SDPA ({backend}) {t_l:.4f} ms;"
        log(f"{key} {path} heads {h}/{kv} S={s} cache_len=20000: kernel {t_k:.4f} ms plain "
            f"{t_p:.3f} ms;{lib_text} bound {b:.4f} ms ({by}), {100 * b / t_k:.1f}% of it")
        records[key]["new_shapes"].append(dict(
            path=path, heads=f"{h}/{kv}", s=s, budget=budget, cache_len=20000, valid_len=s,
            max_abs_err=worst, ms=t_k, plain_ms=t_p, bound_ms=b, bound_by=by,
            bound_share=b / t_k, library_ms=t_l, library_backend=backend))
        # K2 scores this chunk's q / k (bf16)
        worst = 0.0
        for valid_len in (s, s - 305, 1):
            vl = i32(valid_len)
            got, again = k2(q, kn, vl), k2(q, kn, vl)
            want = pivot_scores.pivot_score_sums_plain(q, kn, vl)
            torch.cuda.synchronize()
            check(torch.equal(got, again), ("K2 not bitwise repeatable", path, valid_len))
            err = max_err(got, want)
            worst = max(worst, err)
            log(f"K2 {path} heads {h}/{kv} S={s} valid_len={valid_len}: max_abs_err "
                f"{err:.3e} (tol {K2_TOL})")
            check(err <= K2_TOL, ("K2", path, valid_len, err))
            del got, again, want
        vl = i32(s)
        t_k = cuda_ms(lambda: k2(q, kn, vl), 20)
        t_p = cuda_ms(lambda: pivot_scores.pivot_score_sums_plain(q, kn, vl), 5)
        b, by = bound(2 * d * h * s * s, 2 * h * s * d + 2 * kv * s * d + 4 * kv * s)
        log(f"K2 {path} heads {h}/{kv} S={s}: kernel {t_k:.4f} ms plain {t_p:.3f} ms; bound "
            f"{b:.4f} ms ({by}), {100 * b / t_k:.1f}% of it")
        records["K2"]["new_shapes"].append(dict(
            path=path, heads=f"{h}/{kv}", s=s, valid_len=s, max_abs_err=worst, ms=t_k,
            plain_ms=t_p, bound_ms=b, bound_by=by, bound_share=b / t_k, library_ms=None))
        del q, kc, vc, kn, vn
        torch.cuda.empty_cache()
    # K4 / K4-int8 at the serving bucket: 4 slots, mixed live columns, one
    # all-dead slot in the second case
    b, s = 4, 43008
    cases = [([32002, 18498, 4674, 20000], [40960, 40976, 40992, 40960], 40960, 64),
             ([32002, 18498, 4674, 0], [40960, 40976, 40992, 41024], 40960, 64)]
    k4 = decode_gapped.decode_gapped_flash_state
    for kvh, g, int8, path in TP_K4_CASES:
        key = "K4-int8" if int8 else "K4"
        q = bf16(gen, (b, kvh * g, d), dev)
        kc, vc = bf16(gen, (b, kvh, s, d), dev), bf16(gen, (b, kvh, s, d), dev)
        ks = vs = None
        if int8:
            (kc, ks), (vc, vs) = quantize_kv_block(kc), quantize_kv_block(vc)
        kn, vn = bf16(gen, (b, kvh, d), dev), bf16(gen, (b, kvh, d), dev)
        q4 = q.reshape(b, kvh, g, d)
        worst = 0.0
        for ci, (fl, ds, gap_start, gap_filled) in enumerate(cases):
            final_len, dec_start = i32(fl), i32(ds)
            we = gap_start + gap_filled
            args = (q, kc, vc, final_len, gap_start, gap_filled, kn, vn, ks, vs)
            got = attention.decode_attention_batch_gapped(*args, dec_start=dec_start, impl="pallas")
            want = attention.decode_attention_batch_gapped(*args, dec_start=dec_start, impl="xla")
            sargs = (q4, kc, vc, final_len, dec_start, we) + ((ks, vs) if int8 else ())
            state, again = k4(*sargs), k4(*sargs)
            _, pm, pl = decode_gapped.decode_gapped_flash_state_plain(*sargs)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(state, again)),
                  (key, "not bitwise repeatable", path))
            live = pl > 0
            err, tol = max_err(got, want), bf16_tol(want)
            m_err = max_err(state[1][live], pm[live])
            worst = max(worst, err)
            log(f"{key} {path} B={b} KV={kvh} G={g} S={s} case {ci}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e}), m err {m_err:.3e} (tol {K4_M_TOL})")
            check(err <= tol and m_err <= K4_M_TOL, (key, path, ci, err, tol, m_err))
            if ci == 0:
                t_k = cuda_ms(lambda: k4(*sargs), 20)
                t_p = cuda_ms(lambda: decode_gapped.decode_gapped_flash_state_plain(*sargs), 5)
                n_live = sum(fl) + sum(we - x for x in ds)
                row = 2 * d + 8 if int8 else 4 * d
                flops = 4 * n_live * kvh * g * d
                nbytes = n_live * kvh * row + 2 * b * kvh * g * d + 4 * b * kvh * g * (d + 2)
            del got, want, state, again
        bnd, by = bound(flops, nbytes)
        log(f"{key} {path} KV={kvh} G={g}: kernel {t_k:.4f} ms plain {t_p:.4f} ms; bound "
            f"{bnd:.4f} ms ({by}), {100 * bnd / t_k:.1f}% of it")
        records[key]["new_shapes"].append(dict(
            path=path, heads=f"G {g} / KV {kvh}", b=b, s=s, max_abs_err=worst, ms=t_k,
            plain_ms=t_p, bound_ms=bnd, bound_by=by, bound_share=bnd / t_k, library_ms=None))
        del q, q4, kc, vc, kn, vn, ks, vs
        torch.cuda.empty_cache()


def hf_tensors_of(cfg, params) -> dict:
    """The inverse of ``params.from_hf_tensors``: a Qwen2-VL parameter tree
    under HF tensor names, torch ``[out, in]`` linears, one tensor a layer
    (for writing an HF checkpoint from random weights)."""
    out = {}

    def lin(w):
        return w.transpose(-1, -2).contiguous()

    lp = params["layers"]
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}."
        out[pre + "input_layernorm.weight"] = lp["input_ln"][i]
        out[pre + "post_attention_layernorm.weight"] = lp["post_ln"][i]
        for k in ("q", "k", "v", "o"):
            out[pre + f"self_attn.{k}_proj.weight"] = lin(lp[k]["w"][i])
            if "b" in lp[k]:
                out[pre + f"self_attn.{k}_proj.bias"] = lp[k]["b"][i]
        for k in ("gate", "up", "down"):
            out[pre + f"mlp.{k}_proj.weight"] = lin(lp[k]["w"][i])
    out["model.embed_tokens.weight"] = params["embed_tokens"]
    out["model.norm.weight"] = params["final_ln"]
    if "lm_head" in params:
        out["lm_head.weight"] = lin(params["lm_head"])
    vp, v = params["visual"], cfg.vision
    pw = vp["patch_embed"]["w"]
    out["visual.patch_embed.proj.weight"] = pw.T.reshape(
        pw.shape[1], v.in_channels, v.temporal_patch_size, v.patch_size, v.patch_size).contiguous()
    bp = vp["blocks"]
    for i in range(v.depth):
        pre = f"visual.blocks.{i}."
        for k, name in (("ln1", "norm1"), ("ln2", "norm2")):
            out[pre + name + ".weight"] = bp[k]["scale"][i]
            out[pre + name + ".bias"] = bp[k]["bias"][i]
        for k, name in (("qkv", "attn.qkv"), ("proj", "attn.proj"), ("fc1", "mlp.fc1"),
                        ("fc2", "mlp.fc2")):
            out[pre + name + ".weight"] = lin(bp[k]["w"][i])
            out[pre + name + ".bias"] = bp[k]["b"][i]
    mp = vp["merger"]
    out["visual.merger.ln_q.weight"] = mp["ln_q"]["scale"]
    out["visual.merger.ln_q.bias"] = mp["ln_q"]["bias"]
    for k, j in (("fc1", 0), ("fc2", 2)):
        out[f"visual.merger.mlp.{j}.weight"] = lin(mp[k]["w"])
        out[f"visual.merger.mlp.{j}.bias"] = mp[k]["b"]
    return out


def tree_leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def phase_loading(cfg, model, dev, seed: int, hf_dir: str) -> dict:
    """2B at full width and depth, from disk: ``RetakeConfig.from_yaml`` of
    every file under configs/; the seed's random tree written under HF
    names as two safetensors shards with ``model.safetensors.index.json``
    into ``hf_dir`` (phase 23 reads them again) and read back by
    ``load_safetensors(..., device="cuda")``, every leaf
    bit-identical (load seconds, peak memory); a weight-only int8 tree
    through ``save_params`` -> ``load_checked``, a 64-frame request from
    each tree with the same tokens and first logits; the port demo's
    ``main`` on random weights at 64 frames. Returns the demo's launches."""
    import contextlib
    import glob
    import io

    from retake_tpu_torch import demo
    from retake_tpu_torch.models.qwen2_vl import params as params_lib
    from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
    from retake_tpu_torch.ops.quantization import quantize_llm_int8
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine
    from retake_tpu_torch.utils import checkpoint, safetensors_io
    from retake_tpu_torch.utils.config import RetakeConfig

    root = os.path.dirname(os.path.abspath(__file__))
    yamls = sorted(glob.glob(os.path.join(root, "configs", "**", "*.yaml"), recursive=True))
    parsed = {os.path.relpath(p, root): RetakeConfig.from_yaml(p) for p in yamls}
    log(f"[21] from_yaml: {len(parsed)} config files, model_name "
        f"{sorted({c.model_name for c in parsed.values()})}, attn_implementation "
        f"{sorted({c.attn_implementation for c in parsed.values()})}")
    check(len(parsed) == 15, len(parsed))

    params = params_lib.init_params(cfg, seed=seed, device=dev)
    check(torch.equal(params["layers"]["q"]["w"], model.layers.q.w), "the phase-4 weights")
    hf = hf_tensors_of(cfg, params)
    names = sorted(hf)
    halves = [names[: len(names) // 2], names[len(names) // 2 :]]
    weight_map = {}
    t0 = time.perf_counter()
    for i, part in enumerate(halves):
        shard = f"model-{i + 1:05d}-of-00002.safetensors"
        safetensors_io.save_file({n: hf[n] for n in part}, os.path.join(hf_dir, shard))
        weight_map.update({n: shard for n in part})
    with open(os.path.join(hf_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    del hf
    gb = sum(os.path.getsize(os.path.join(hf_dir, f)) for f in os.listdir(hf_dir)) / 1e9
    log(f"[21] wrote the random 2B tree as 2 HF shards ({gb:.2f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loaded = params_lib.load_safetensors(hf_dir, cfg, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        want, got = tree_leaves(params), tree_leaves(loaded)
        same = set(want) == set(got) and all(
            got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)
        tree_gb = sum(x.numel() * x.element_size() for x in want.values()) / 1e9
        log(f"[21] load_safetensors (index, 2 shards) -> cuda in {load_s:.2f} s: {len(got)} "
            f"leaves bit-identical {same}; peak memory above the resident {peak / 2**30:.2f} GiB "
            f"for a {tree_gb:.2f} GB tree")
        check(same, "HF shards -> load_safetensors")
        del loaded, got

        ckpt = os.path.join(tmp, "quantized")
        qtree = quantize_llm_int8(params)
        t0 = time.perf_counter()
        checkpoint.save_params(qtree, ckpt, meta={"model_name": "qwen2_vl", "weights": "int8"})
        save_s = time.perf_counter() - t0
        rt8 = RetakeConfig.from_dict(dict(RETAKE_CONFIG, quantization="int8"))
        t0 = time.perf_counter()
        qloaded = checkpoint.load_checked(ckpt, rt8, "qwen2_vl", device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        qa, qb = tree_leaves(qtree), tree_leaves(qloaded)
        same = set(qa) == set(qb) and all(
            qa[k].dtype == qb[k].dtype and torch.equal(qa[k], qb[k]) for k in qa)
        check(same, "save_params -> load_checked")
        ids, patches, grid = build_request(cfg, 64, dev, seed + 21)
        res = [Qwen2VLEngine(cfg, Qwen2VLModel(cfg, tree), rt8, device=dev).generate(
            ids, patches, grid, max_new_tokens=MAX_NEW_TOKENS) for tree in (qtree, qloaded)]
        same_req = (np.array_equal(res[0].tokens, res[1].tokens)
                    and np.array_equal(res[0].first_logits, res[1].first_logits))
        log(f"[21] int8 checkpoint: save {save_s:.2f} s, load_checked {load_s:.2f} s, leaves "
            f"bit-identical {same}; 64-frame request from each tree: tokens and first logits "
            f"identical {same_req} ({res[0].tokens[:4].tolist()})")
        check(same_req, "requests from the saved and the loaded int8 tree")
        del qtree, qloaded, qa, qb, res, patches
    del params
    torch.cuda.empty_cache()

    out = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = demo.main(["--random-weights", "--frames", "64", "--json", "--device", str(dev),
                        "--max_new_tokens", str(GATE_TOKENS),
                        "--config", os.path.join(root, "configs", "retake_demo.yaml")])
    n = read_counts()
    lines = out.getvalue().strip().splitlines()
    answers = json.loads(lines[-1])
    log(f"[21] demo --random-weights --frames 64 --json --max_new_tokens {GATE_TOKENS}: exit {rc} in "
        f"{time.perf_counter() - t0:.1f} s; answers {answers['answers']} (random weights), "
        f"token counts {[len(t) for t in answers['tokens']]}; launches {n}; "
        + " | ".join(line for line in lines if line.startswith("[")))
    check(rc == 0 and len(answers["tokens"]) == 3 and all(answers["tokens"]), answers)
    # configs/retake_demo.yaml selects "flash": K3 in the ViT, no K1 / K2
    check(n["K3"] > 0 and n["K1"] == n["K2"] == 0, n)
    torch.cuda.empty_cache()
    return n


def llava_request(cfg, frames: int, dev, seed: int):
    """ids (16 prompt ids, the video span of frames x 196 + 1, a 48-id
    question) and random 384x384 uint8 frames drawn on the card."""
    rng = np.random.default_rng(seed)
    ids = np.array(rng.integers(10, 1000, size=16).tolist()
                   + [cfg.video_token_id] * (frames * cfg.tokens_per_frame + 1)
                   + rng.integers(10, 1000, size=48).tolist(), dtype=np.int64)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    s = cfg.vision.image_size
    vid = torch.randint(0, 256, (frames, s, s, 3), generator=gen, device=dev, dtype=torch.uint8)
    return ids, vid


def phase_llava(dev, args, ref=None) -> dict:
    """LLaVA-Video-7B at full width and depth (``LlavaOnevisionConfig()``),
    random bf16 weights drawn on the card from the seed, under
    configs/llava_video/retake_llava-video_videomme.yaml with
    attn_implementation "pallas": one request at ``--llava-frames`` (cold,
    warm with stage times, bit-exact), launches (K1 = 28 x plan steps,
    K2 = 28 x video chunks, no K3), SigLIP's time; at 64 frames kernel vs
    plain arm and "flash" vs "pallas", prefix reuse, a 3-request
    ``generate_batch`` (K4) and a W8A8 request against bf16. Returns the
    launches by path; ``ref`` (a dict) gets the 64-frame kernel-path
    request's first logits and cache positions (phase 24's tp = 1
    reference)."""
    from retake_tpu_torch.models.llava_onevision import params as lparams
    from retake_tpu_torch.models.llava_onevision.config import LlavaOnevisionConfig
    from retake_tpu_torch.models.llava_onevision.model import LlavaOnevisionModel
    from retake_tpu_torch.ops import quantization as q8
    from retake_tpu_torch.runtime.engine import plan_chunks
    from retake_tpu_torch.runtime.llava_engine import LlavaOnevisionEngine
    from retake_tpu_torch.utils.config import RetakeConfig

    root = os.path.dirname(os.path.abspath(__file__))
    rt = dataclasses.replace(RetakeConfig.from_yaml(os.path.join(root, LLAVA_YAML)),
                             attn_implementation="pallas")
    cfg = LlavaOnevisionConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lparams.init_params(cfg, seed=args.seed, device=dev)
    model = LlavaOnevisionModel(cfg, params)
    torch.cuda.synchronize()
    gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    vgb = sum(p.numel() * p.element_size() for p in model.vision_tower.parameters()) / 1e9
    log(f"[22] LLaVA-Video-7B built in {time.perf_counter() - t0:.1f} s: {gb:.2f} GB of bf16 "
        f"weights ({vgb:.2f} GB SigLIP), text {cfg.text.num_hidden_layers} x "
        f"{cfg.text.hidden_size}, heads {cfg.text.num_attention_heads}/"
        f"{cfg.text.num_key_value_heads}; SigLIP {cfg.vision.num_hidden_layers} x "
        f"{cfg.vision.hidden_size}, {cfg.vision.num_patches} patches -> {cfg.tokens_per_frame} "
        f"tokens a frame; config {LLAVA_YAML} (frame_chunk_size {rt.frame_chunk_size}, "
        f"chunked_prefill_frames {rt.chunked_prefill_frames}, max_input_length "
        f"{rt.kv.max_input_length}, YaRN x{rt.scaling_factor}), attn pallas")
    engine = LlavaOnevisionEngine(cfg, model, rt, device=dev)
    paths = {}
    frames = args.llava_frames
    ids, vid = llava_request(cfg, frames, dev, args.seed)
    ratio = rt.compression_ratio_for(len(ids))
    plan, final_len, _ = plan_chunks(ids, cfg.video_token_id, engine.get_chunk_tokens(frames),
                                     ratio, ratio < 1.0)
    n_video = sum(p["kind"] == "video" for p in plan)
    log(f"[22] request: {frames} frames of 384x384, {len(ids)} tokens, ratio {ratio:.4f}, "
        f"{len(plan)} prefill steps ({n_video} video chunks, the last of "
        f"{plan[-2]['valid']} rows), planned cache {final_len}")
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = engine.generate(ids, vid, max_new_tokens=MAX_NEW_TOKENS)
    n = read_counts()
    peak = torch.cuda.max_memory_allocated()
    paths["22"] = n
    L = cfg.text.num_hidden_layers
    log(f"[22] cold: TTFT {res.prefill_seconds:.3f} s, decode {res.decode_seconds:.3f} s for "
        f"{len(res.tokens) - 1} tokens, peak memory {peak / 2**30:.2f} GiB; launches {n}; tokens "
        f"{res.tokens.tolist()}")
    check(n["K1"] == L * len(plan) and n["K2"] == L * n_video and n["K3"] == 0
          and n["K4"] == n["K1-int8"] == 0, (n, len(plan), n_video))
    check(res.cache_fill == res.cache_len == final_len and np.isfinite(res.first_logits).all()
          and ((res.tokens >= 0) & (res.tokens < cfg.text.vocab_size)).all(), res.tokens)
    os.environ["RETAKE_PROFILE"] = "1"
    res2 = engine.generate(ids, vid, max_new_tokens=MAX_NEW_TOKENS)
    os.environ.pop("RETAKE_PROFILE")
    m = int(res.cache.length)
    same = {"tokens": np.array_equal(res.tokens, res2.tokens),
            "first_logits": np.array_equal(res.first_logits, res2.first_logits),
            **{f: torch.equal(getattr(res.cache, f)[:, :, :m], getattr(res2.cache, f)[:, :, :m])
               for f in ("k", "v", "pos")}}
    log(f"[22] warm (stage timer on): TTFT {res2.prefill_seconds:.3f} s, decode "
        f"{res2.decode_seconds:.3f} s; stages "
        + json.dumps({k: round(v, 4) for k, v in (res2.stages or {}).items()})
        + f"; bit-exact repeat {same}")
    check(all(same.values()), same)
    del res, res2
    # SigLIP alone: one frame_chunk_size chunk (plain attention, fp32 logits)
    chunk = vid[: rt.frame_chunk_size]
    ms = cuda_ms(lambda: engine._tower(chunk), 3, 1)
    log(f"[22] SigLIP tower, {chunk.shape[0]} frames (26 layers, plain attention with fp32 "
        f"logits): {ms:.2f} ms a chunk, {ms * frames / chunk.shape[0] / 1e3:.3f} s for "
        f"{frames} frames (CUDA events, median of 3)")
    del vid, chunk
    torch.cuda.empty_cache()

    # 64 frames: kernel vs plain arm, and the published "flash" arm
    rd64 = dataclasses.replace(rt, kv=dataclasses.replace(rt.kv, max_input_length=8000))
    ids6, vid6 = llava_request(cfg, 64, dev, args.seed + 1)
    out, ttft, launches = {}, {}, {}
    for impl in ("pallas", "xla", "flash"):
        eng = LlavaOnevisionEngine(cfg, model, dataclasses.replace(rd64, attn_implementation=impl),
                                   device=dev)
        zero_counts()
        out[impl] = eng.generate(ids6, vid6, max_new_tokens=MAX_NEW_TOKENS)
        launches[impl] = read_counts()
        ttft[impl] = round(out[impl].prefill_seconds, 3)
        del eng
        torch.cuda.empty_cache()
    a = out["pallas"]
    for impl in ("xla", "flash"):
        b = out[impl]
        rel = float(np.abs(a.first_logits - b.first_logits).max() / np.abs(b.first_logits).max())
        kept = kept_agreement(a.cache, b.cache, a.cache_fill)
        log(f"[22] 64 frames, pallas vs {impl}: cache {a.cache_fill}; TTFT pallas "
            f"{ttft['pallas']} s, {impl} {ttft[impl]} s; first logits rel max|diff| {rel:.4f} "
            f"(bound {LLAVA_REL_LOGIT_TOL}), kept entries in common {kept:.4f} (bound "
            f"{LLAVA_MIN_KEPT}); launches {launches[impl]}; tokens {a.tokens[:4].tolist()} / "
            f"{b.tokens[:4].tolist()}")
        check(a.cache_fill == b.cache_fill == a.cache_len < len(ids6), (a.cache_fill, b.cache_fill))
        check(rel <= LLAVA_REL_LOGIT_TOL and kept >= LLAVA_MIN_KEPT, (impl, rel, kept))
        check(launches[impl]["K1"] == launches[impl]["K2"] == 0, launches[impl])
    if ref is not None:
        ref.update(first_logits=a.first_logits,
                   pos=a.cache.pos[:, :, :a.cache_fill].cpu().numpy())
    plain_kept = kept_agreement(out["xla"].cache, out["flash"].cache, a.cache_fill)
    log(f"[22] 64 frames, the two plain arms (xla vs flash, the same plain PivotKV scores): "
        f"kept entries in common {plain_kept:.4f}")
    paths["22 64 frames"] = launches["pallas"]
    bf16_logits = a.first_logits
    del out, a, b
    torch.cuda.empty_cache()

    # prefix reuse: two questions bit-exact against inline
    questions = [ids6, np.concatenate([ids6[:-48], np.random.default_rng(args.seed + 2).integers(
        10, 1000, size=48)])]
    eng = LlavaOnevisionEngine(cfg, model, rd64, device=dev)
    prefix = eng.encode_prefix(ids6, vid6, max_new_tokens=MAX_NEW_TOKENS)
    for i, q in enumerate(questions):
        inline = eng.generate(q, vid6, max_new_tokens=MAX_NEW_TOKENS)
        zero_counts()
        reused = eng.generate(q, prefix=prefix, max_new_tokens=MAX_NEW_TOKENS)
        n = read_counts()
        same = (np.array_equal(reused.tokens, inline.tokens)
                and np.array_equal(reused.first_logits, inline.first_logits))
        log(f"[22] prefix question {i}: TTFT {reused.prefill_seconds:.3f} s (inline "
            f"{inline.prefill_seconds:.3f} s), bit-exact {same}; launches {n}")
        check(same and n["K1"] == L and n["K2"] == 0, (i, same, n))
    del prefix, inline, reused

    # generate_batch: three requests, batched decode through K4
    reqs = []
    for i, f in enumerate((64, 128, 64)):
        r_ids, r_vid = llava_request(cfg, f, dev, args.seed + 30 + i)
        reqs.append(dict(input_ids=r_ids, pixel_values_videos=r_vid))
    zero_counts()
    t0 = time.perf_counter()
    batch = eng.generate_batch(reqs, max_new_tokens=MAX_NEW_TOKENS)
    wall = time.perf_counter() - t0
    n = read_counts()
    steps = max(len(x.tokens) for x in batch) - 1
    log(f"[22] generate_batch (64, 128, 64 frames) in {wall:.3f} s: launches {n}; tokens "
        f"{[x.tokens[:4].tolist() for x in batch]}")
    check(n["K4"] >= L * steps > 0 and n["K3"] == 0, (n, steps))
    check(all(np.isfinite(x.first_logits).all() for x in batch), "batch logits")
    paths["22 generate_batch"] = n
    del eng, reqs, batch
    torch.cuda.empty_cache()

    # W8A8: the same weights quantized (text, SigLIP, projector)
    del engine
    qmodel = LlavaOnevisionModel(cfg, q8.quantize_siglip_int8(q8.quantize_llm_int8(params)))
    check(qmodel.int8 and qmodel.vision_int8, "int8 weights")
    eng = LlavaOnevisionEngine(cfg, qmodel, dataclasses.replace(rd64, quantization="w8a8"),
                               device=dev)
    zero_counts()
    res = eng.generate(ids6, vid6, max_new_tokens=MAX_NEW_TOKENS)
    n = read_counts()
    a, b = res.first_logits, bf16_logits
    rel = float(np.abs(a - b).max() / np.abs(b).max())
    cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    log(f"[22] W8A8 (text, SigLIP, projector int8), 64 frames: TTFT {res.prefill_seconds:.3f} s; "
        f"first logits vs bf16 rel max|diff| {rel:.4f} (bound {W8_REL_LOGIT_TOL}), cosine "
        f"{cos:.5f} (bound {W8_MIN_COSINE}); launches {n}")
    check(np.isfinite(a).all() and rel <= W8_REL_LOGIT_TOL and cos >= W8_MIN_COSINE, (rel, cos))
    paths["22 w8a8"] = n
    del eng, qmodel, model, params, res, vid6
    torch.cuda.empty_cache()
    return paths


# ---------- phase 23: the eval runner, the quantizer, the host pipeline


def hf_config_of(cfg) -> dict:
    """A ``config.json`` that ``Qwen2VLConfig.from_pretrained`` reads back as
    ``cfg``."""
    v = cfg.vision
    return {
        "model_type": "qwen2_vl", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads, "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta, "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "rope_scaling": {"type": "mrope", "mrope_section": list(cfg.mrope_section)},
        "bos_token_id": cfg.bos_token_id, "eos_token_id": cfg.eos_token_id,
        "vision_start_token_id": cfg.vision_start_token_id,
        "vision_end_token_id": cfg.vision_end_token_id, "image_token_id": cfg.image_token_id,
        "video_token_id": cfg.video_token_id,
        "vision_config": {"depth": v.depth, "embed_dim": v.embed_dim,
                          "hidden_size": v.hidden_size, "mlp_ratio": v.mlp_ratio,
                          "num_heads": v.num_heads, "in_channels": v.in_channels,
                          "patch_size": v.patch_size, "spatial_merge_size": v.spatial_merge_size,
                          "temporal_patch_size": v.temporal_patch_size},
    }


def eval_yaml(root: str, tmp: str, out_dir: str, anno_file: str, **extra) -> str:
    """A copy of the serving config with only anno_file, output_dir,
    dataloader_num_workers and max_new_tokens (EVAL_TOKENS) rewritten (and
    ``extra``)."""
    import yaml

    with open(os.path.join(root, SERVING_YAML)) as f:
        d = yaml.safe_load(f)
    d.update(anno_file=anno_file, output_dir=out_dir, dataloader_num_workers=EVAL_WORKERS,
             max_new_tokens=EVAL_TOKENS, **extra)
    path = os.path.join(tmp, os.path.basename(out_dir) + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


def journal(out_dir: str, rank: int = 0) -> list:
    with open(os.path.join(out_dir, f"shard_{rank:03d}.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_eval_in_process(engine, processor, dataset, rt) -> tuple:
    """The runner's one-process run (``run_eval`` + ``merge_and_score``):
    (launches, seconds, stdout, tokens by idx, new journal records)."""
    import contextlib
    import io

    from retake_tpu_torch.eval import infer_eval

    seen = []
    decode = processor.decode
    processor.decode = lambda ids, **kw: (seen.append(np.asarray(ids)), decode(ids, **kw))[1]
    out_dir = rt.output_dir
    before = len(journal(out_dir)) if os.path.exists(os.path.join(out_dir, "shard_000.jsonl")) \
        else 0
    out = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        infer_eval.run_eval(engine, processor, dataset, rt, 0, 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        infer_eval.merge_and_score(rt, 1)
    n = read_counts()
    processor.decode = decode
    recs = journal(out_dir)[before:]
    tokens = {rec["idx"]: toks for rec, toks in zip(recs, seen)}
    return n, wall, out.getvalue(), tokens, recs


def host_pipeline(host_dir: str) -> None:
    """``load_frame_dir`` and ``preprocess_video`` at HOST_FRAMES 448x252
    frames, the host work of an eval sample or an HTTP miss: the native
    library's state (its patchify half must build here; the JPEG half needs
    libjpeg), which path decoded the frames, and ``preprocess_video``
    through the native patchify beside the numpy path (held to each other
    at NATIVE_PATCH_TOL)."""
    from retake_tpu_torch import native
    from retake_tpu_torch.data import processor as proc_lib
    from retake_tpu_torch.data import video

    t0 = time.perf_counter()
    status = native.status()
    t_build = time.perf_counter() - t0
    log(f"[23] native host pipeline ({t_build:.2f} s to build or load): {json.dumps(status)}")
    check(status["patchify"].startswith("built"), ("the patchify half did not build", status))
    decoder = ("native (libjpeg + C++ NEAREST)" if status["jpeg"].startswith("built")
               else "PIL (the JPEG half is not built here)")
    t0 = time.perf_counter()
    frames = video.load_frame_dir(host_dir, 2048, 4, 4, 448)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat, grid = proc_lib.preprocess_video(frames)
    t_prep = time.perf_counter() - t0
    stacked = np.stack(frames)
    t0 = time.perf_counter()
    native.patchify_qwen(stacked)
    t_patch = time.perf_counter() - t0
    del stacked
    patchify = native.patchify_qwen

    def unavailable(*a, **kw):
        raise native.NativeUnavailable("the numpy path, for comparison")

    native.patchify_qwen = unavailable
    try:
        t0 = time.perf_counter()
        flat_np, grid_np = proc_lib.preprocess_video(frames)
        t_numpy = time.perf_counter() - t0
    finally:
        native.patchify_qwen = patchify
    err = max(float(np.abs(flat[i:i + 65536] - flat_np[i:i + 65536]).max())
              for i in range(0, len(flat), 65536))
    h, w = frames[0].shape[:2]
    log(f"[23] host pipeline, {len(frames)} frames {w}x{h} on {os.cpu_count()} cores: "
        f"load_frame_dir {t_load:.2f} s, decoded by {decoder}; preprocess_video (PIL bicubic + "
        f"native patchify) {t_prep:.2f} s, of it patchify_qwen alone {t_patch:.2f} s; the numpy "
        f"path {t_numpy:.2f} s -> patches {tuple(flat.shape)} grid {grid}; native vs numpy "
        f"max|diff| {err:.3e} (bound {NATIVE_PATCH_TOL})")
    check(len(frames) == HOST_FRAMES and grid == grid_np == (HOST_FRAMES // 2, h // 14, w // 14),
          ("host pipeline", len(frames), grid, grid_np))
    check(err <= NATIVE_PATCH_TOL, ("native vs numpy patches", err))


def phase_eval(cfg, dev, seed: int, hf_dir: str) -> dict:
    """The eval runner on the card under the serving config (2B, full width
    and depth, random seed weights): the quantizer over phase 21's HF
    checkpoint (leaves bit-identical to quantizing the loaded tree here);
    ``run_eval`` + ``merge_and_score`` in this process through
    ``_load_engine``'s pre-quantized branch (K1-int8, K2 and K3 in every
    sample, no K4; every index journaled once; the three files); a resume
    that runs nothing; the CLI as two processes joined by torch.distributed
    on this card over MULTI_VIDEOS videos (rank 0 merges every index once);
    reuse of each video's features and prefix (every question reused, every
    sample's tokens equal to the inline run's); the host pipeline at
    HOST_FRAMES frames. Returns the in-process run's launches."""
    from retake_tpu_torch.data.datasets import get_dataset
    from retake_tpu_torch.data.processor import Qwen2VLProcessor
    from retake_tpu_torch.eval import infer_eval
    from retake_tpu_torch.eval.synthetic import free_port, save_offline_tokenizer, write_videomme
    from retake_tpu_torch.models.qwen2_vl import params as params_lib
    from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig
    from retake_tpu_torch.ops.quantization import quantize_llm_int8, quantize_vit_int8
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine
    from retake_tpu_torch.utils import checkpoint
    from retake_tpu_torch.utils.config import RetakeConfig

    root = os.path.dirname(os.path.abspath(__file__))
    n_samples = EVAL_RUN_VIDEOS * EVAL_QUESTIONS
    with open(os.path.join(hf_dir, "config.json"), "w") as f:
        json.dump(hf_config_of(cfg), f)
    check(Qwen2VLConfig.from_pretrained(hf_dir) == cfg, "config.json of the 2B geometry")
    save_offline_tokenizer(hf_dir)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        anno_file = write_videomme(tmp, [EVAL_QUESTIONS] * EVAL_VIDEOS, EVAL_FRAMES, 448, 252,
                                   seed + 23, block=4)
        host_dir = os.path.join(tmp, "frames")
        os.makedirs(host_dir)
        for v in range(EVAL_VIDEOS):
            for i in range(EVAL_FRAMES):
                os.symlink(os.path.join(tmp, f"vid{v}", f"{i:06d}.jpg"),
                           os.path.join(host_dir, f"{v * EVAL_FRAMES + i:06d}.jpg"))
        with open(anno_file) as f:
            annos = json.load(f)
        run_anno = os.path.join(tmp, "videomme_run.json")  # the first EVAL_RUN_VIDEOS videos
        with open(run_anno, "w") as f:
            json.dump(annos[:n_samples], f)
        log(f"[23] wrote {HOST_FRAMES} JPEG frames (448x252) and a "
            f"{EVAL_VIDEOS * EVAL_QUESTIONS}-sample Video-MME benchmark ({EVAL_VIDEOS} videos x "
            f"{EVAL_FRAMES} frames; the runs take the first {n_samples} samples, "
            f"{EVAL_TOKENS} tokens each) in {time.perf_counter() - t0:.1f} s")

        # the quantizer, as a user runs it, over phase 21's checkpoint
        qdir = os.path.join(tmp, "int8")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "retake_tpu_torch.tools.quantize_checkpoint", "--hf_path",
             hf_dir, "--out", qdir, "--vit"], cwd=root, capture_output=True, text=True,
            timeout=600)
        q_s = time.perf_counter() - t0
        check(out.returncode == 0, ("quantize_checkpoint", out.stdout[-2000:], out.stderr[-4000:]))
        files = json.loads(out.stdout.strip().splitlines()[-1])["files"]
        peak = [line for line in out.stderr.splitlines() if "peak device memory" in line]
        want = quantize_llm_int8(params_lib.load_safetensors(hf_dir, cfg, device=dev))
        want["visual"] = quantize_vit_int8(want["visual"])
        want, got = tree_leaves(want), tree_leaves(checkpoint.load_params(qdir, device=dev))
        same = set(want) == set(got) and all(
            got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)
        gb = os.path.getsize(os.path.join(qdir, checkpoint.FILENAME)) / 1e9
        hf_gb = sum(os.path.getsize(os.path.join(hf_dir, f)) for f in os.listdir(hf_dir)
                    if f.endswith(".safetensors")) / 1e9
        log(f"[23] quantize_checkpoint --vit: exit 0 in {q_s:.1f} s (a new process: start-up, "
            f"{hf_gb:.2f} GB read, quantized on the card, {gb:.2f} GB written); "
            f"{peak[-1].strip() if peak else 'no peak line'}; files {files}; {len(got)} leaves "
            f"bit-identical to quantize_llm_int8 / quantize_vit_int8 of the loaded tree here: "
            f"{same}")
        check(same, "the quantizer's tree")
        del want, got
        torch.cuda.empty_cache()

        # one process, in this process: _load_engine's pre-quantized branch
        inline_dir = os.path.join(tmp, "inline")
        rt = RetakeConfig.from_yaml(eval_yaml(root, tmp, inline_dir, run_anno))
        t0 = time.perf_counter()
        engine = infer_eval._load_engine(None, qdir, rt, dev)
        processor = Qwen2VLProcessor.from_pretrained(qdir)
        dataset = get_dataset(rt.dataset_name, rt.anno_file, processor_kwargs=dict(
            video_fps=rt.sample_fps, video_maxlen=rt.max_num_frames,
            image_resolution=rt.longsize_resolution, video_frame_extraction_fps=4))
        log(f"[23] engine from the int8 tree in {time.perf_counter() - t0:.1f} s "
            f"(quantization {rt.quantization}, kv_cache_dtype {rt.kv_cache_dtype}, "
            f"eval_batch_size {rt.eval_batch_size}, attn {rt.attn_implementation}, "
            f"max_new_tokens {rt.max_new_tokens})")
        n, wall, _, inline_tokens, recs = run_eval_in_process(engine, processor, dataset, rt)
        idxs = sorted(rec["idx"] for rec in recs)
        arts = [a for a in ("anno_id2result.json", "infer_results.csv", "eval_results.csv")
                if os.path.exists(os.path.join(inline_dir, a))]
        m = [rec["metrics"] for rec in recs]
        log(f"[23] run_eval, one process: {n_samples} samples in {wall:.1f} s "
            f"({wall / n_samples:.2f} s a sample); journal prefill_s "
            f"{[x['prefill_s'] for x in m]}, decode_s {[x['decode_s'] for x in m]}, "
            f"input_tokens {m[0]['input_tokens']}, cache_tokens {m[0]['cache_tokens']}, "
            f"new_tokens {[x['new_tokens'] for x in m]}; launches {n} "
            f"({ {k: v / n_samples for k, v in n.items()} } a sample); files {arts}")
        check(idxs == list(range(n_samples)) and len(arts) == 3, (idxs, arts))
        # a sample: K2 in every layer of every 32-frame chunk, K1-int8 in every
        # layer of those and of the text steps, K3 in every block of every
        # 128-step ViT chunk (t = frames / 2); no batched-decode kernel
        chunks, vit_chunks = EVAL_FRAMES // 32, math.ceil(EVAL_FRAMES // 2 / 128)
        check(n["K2"] == 28 * chunks * n_samples and n["K1-int8"] % 28 == 0
              and n["K1-int8"] > n["K2"] and n["K3"] == 32 * vit_chunks * n_samples
              and n["K4"] == n["K4-int8"] == n["K1"] == 0, ("eval launches", n))
        launches = n

        # resume: every index is journaled, so nothing runs
        n, wall, _, _, recs = run_eval_in_process(engine, processor, dataset, rt)
        log(f"[23] resume: {len(recs)} samples journaled, launches {n}, {wall:.2f} s")
        check(not recs and not any(n.values()), ("resume ran work", n, len(recs)))

        # reuse of each video's features and captured prefix
        reuse_dir = os.path.join(tmp, "reuse")
        rt_reuse = RetakeConfig.from_yaml(
            eval_yaml(root, tmp, reuse_dir, run_anno, reuse_video_features=True))
        engine = Qwen2VLEngine(Qwen2VLConfig.from_pretrained(qdir), engine.model, rt_reuse,
                               device=dev)
        n, wall, stdout, reuse_tokens, recs = run_eval_in_process(
            engine, processor, dataset, rt_reuse)
        summary = [line for line in stdout.splitlines() if "prefix reuse summary" in line]
        same = [bool(np.array_equal(inline_tokens[i], reuse_tokens[i])) for i in range(n_samples)]
        with open(os.path.join(inline_dir, "anno_id2result.json")) as f:
            a_inline = json.load(f)
        with open(os.path.join(reuse_dir, "anno_id2result.json")) as f:
            a_reuse = json.load(f)
        same_answers = sum(a_inline[k] == a_reuse[k] for k in a_inline) / n_samples
        log(f"[23] reuse_video_features: {n_samples} samples in {wall:.1f} s; {summary}; "
            f"launches {n}; tokens equal to the inline run's per sample {same}, answers "
            f"equal {same_answers:.3f}")
        check(summary and f"reused={n_samples}," in summary[0] and all(same)
              and n["K3"] == 32 * vit_chunks * EVAL_RUN_VIDEOS, ("reuse", summary, same, n))
        del engine, processor, dataset
        torch.cuda.empty_cache()

        # the CLI, two processes on this card, over the first MULTI_VIDEOS videos
        multi_dir = os.path.join(tmp, "multi")
        n_multi = MULTI_VIDEOS * EVAL_QUESTIONS
        annos = annos[:n_multi]
        multi_anno = os.path.join(tmp, "videomme_multi.json")
        with open(multi_anno, "w") as f:
            json.dump(annos, f)
        cfg_path = eval_yaml(root, tmp, multi_dir, multi_anno)
        coordinator = f"127.0.0.1:{free_port()}"
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "retake_tpu_torch.eval.infer_eval", "--hf_path", qdir,
             "--config_path", cfg_path, "--video_frame_extraction_fps", "4", "--coordinator",
             coordinator, "--num_processes", "2", "--process_id", str(k)],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for k in range(2)]
        try:
            outs = [pr.communicate(timeout=900)[0] for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        wall = time.perf_counter() - t0
        codes = [pr.returncode for pr in procs]
        check(codes == [0, 0], ("two-process eval", codes, [o[-3000:] for o in outs]))
        shards = [sorted(rec["idx"] for rec in journal(multi_dir, r)) for r in range(2)]
        with open(os.path.join(multi_dir, "anno_id2result.json")) as f:
            merged = json.load(f)
        log(f"[23] two processes (--coordinator {coordinator}, gloo, both on {dev}): exit "
            f"{codes} in {wall:.1f} s; shards {shards}; rank 0 merged {len(merged)} samples")
        check(shards == [list(range(0, n_multi, 2)), list(range(1, n_multi, 2))]
              and sorted(merged, key=int) == [str(i) for i in range(n_multi)],
              ("two-process merge", shards, sorted(merged)))

        host_pipeline(host_dir)
    torch.cuda.empty_cache()
    return launches


# ---------- phase 25: the first-checkpoint gate and the TTFT / TPOT tool


def pallas_copy(root: str, rel: str, tmp: str) -> str:
    """A copy of ``rel`` in ``tmp`` with ``attn_implementation: "pallas"``
    and nothing else changed."""
    with open(os.path.join(root, rel)) as f:
        text, n = re.subn(r'^attn_implementation: "flash"', 'attn_implementation: "pallas"',
                          f.read(), flags=re.M)
    check(n == 1, (rel, "has no single attn_implementation: \"flash\" line"))
    path = os.path.join(tmp, "pallas_" + os.path.basename(rel))
    with open(path, "w") as f:
        f.write(text)
    return path


def brief(rec: dict) -> dict:
    """A stage record without its token lists (their lengths instead)."""
    out = {}
    for k, v in rec.items():
        if k == "tokens" and isinstance(v, list) and all(isinstance(t, list) for t in v):
            out["token_counts"] = [len(t) for t in v]
        elif k in ("tokens", "streams"):
            continue
        else:
            out[k] = v
    return out


def gate_in_process(argv, counted, counts) -> dict:
    """Phase 25's gate in this process: every stage through ``counted``,
    which appends each stage's launches to ``counts``; the checks on what
    holds on random weights. Returns the launches, summed."""
    from retake_tpu_torch.tools import first_checkpoint_gate as gate

    t0 = time.perf_counter()
    rep = gate.report(argv, run=counted)
    t_in = time.perf_counter() - t0
    total = {k: sum(n[k] for n in counts) for k in counts[0]}
    for key in GATE_KEYS[:-1]:
        log(f"[25] {key}: {json.dumps(brief(rep[key]))}")
    log(f"[25] in process, the kernels: {t_in:.1f} s, pass {rep['pass']}, launches {total}")
    errs = {k: v["error"] for k, v in rep.items() if k != "pass" and "error" in v}
    check(tuple(rep) == GATE_KEYS and not errs, ("gate stages", list(rep), errs))
    check(set(rep["quant"]["agreement_vs_bf16"])
          == {"int8-weights", "w8a8", "int8kv-only", "w8a8+int8kv"}, rep["quant"])
    check(rep["prefix_parity"]["token_exact"], ("prefix reuse not token-exact", rep["prefix_parity"]))
    check(len(rep["spec_parity"]["agree_prefix_lens"]) == 3, rep["spec_parity"])
    check(rep["serve_decode_parity"]["token_agreement"] >= GATE_MIN_AGREEMENT,
          ("plain vs K4 serving streams", rep["serve_decode_parity"]["token_agreement"]))
    check(rep["http_golden"]["status"] == 200 and rep["http_golden"]["n_tokens"] > 0,
          rep["http_golden"])
    check(os.path.exists(os.path.join(rep["videomme_slice"]["results_dir"], "eval_results.csv")),
          rep["videomme_slice"])
    check(all(total[k] > 0 for k in ("K1", "K1-int8", "K2", "K3", "K4")),
          ("a kernel never launched on the gate's path", total))
    log("[25] waiting for real weights: demo goldens (golden_pass "
        f"{rep['demo']['golden_pass']}), quant >= 0.90 (ok {rep['quant']['ok']}), HTTP "
        f"golden (answer {rep['http_golden']['answer']!r}), Video-MME slice accuracy "
        f"{rep['videomme_slice']['slice_accuracy']}")
    return total


def phase_gate(seed: int, hf_dir: str, smi: str) -> dict:
    """The first-checkpoint gate on phase 21's 2B checkpoint (phase 23 added
    its config.json and tokenizer): every stage through the gate's
    ``report`` in this process, under copies of the published configs with
    the kernels, each stage's launches read around it; beside it
    ``python -m retake_tpu_torch.tools.first_checkpoint_gate`` as a process
    under the published configs ("flash": no K1 or K2), as a user runs it;
    then ``tools/cal_ttft.py`` at TTFT_FRAMES frames, alone. Random weights cannot
    give the golden answers: the checks are what holds on them. Returns the
    in-process stages' launches, summed."""
    from retake_tpu_torch.eval.synthetic import write_frames, write_videomme
    from retake_tpu_torch.tools import cal_ttft
    from retake_tpu_torch.tools import first_checkpoint_gate as gate

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        video = os.path.join(tmp, "video")
        os.makedirs(video)
        write_frames(video, GATE_FRAMES, 448, 252, seed + 25, block=4)
        anno = write_videomme(os.path.join(tmp, "videomme"), [GATE_SAMPLES],
                              GATE_VIDEOMME_FRAMES, 448, 252, seed + 26, block=4)
        demo_cfg, vm_cfg = (pallas_copy(root, rel, tmp) for rel in GATE_CONFIGS)
        argv = ["--hf_path", hf_dir, "--video", video, "--video_frame_extraction_fps", "4",
                "--videomme_anno", anno, "--videomme_samples", str(GATE_SAMPLES),
                "--quant_frames", str(GATE_QUANT_FRAMES), "--max_new_tokens", str(GATE_TOKENS),
                "--device", "cuda"]
        log(f"[25] wrote a {GATE_FRAMES}-frame and a {GATE_VIDEOMME_FRAMES}-frame 448x252 JPEG "
            f"directory and the {GATE_SAMPLES}-sample Video-MME slice in "
            f"{time.perf_counter() - t0:.1f} s; configs {', '.join(GATE_CONFIGS)} copied with "
            f'attn_implementation "pallas"')

        counts = []

        def counted(module, margv, timeout_s=0):
            zero_counts()
            t = time.perf_counter()
            rc, rec, err = gate.in_process(module, margv, timeout_s)
            torch.cuda.synchronize()
            n = read_counts()
            counts.append(n)
            flags = " ".join(a for a in margv if a in ("--spec", "--no-reuse"))
            log(f"[25] {module} {flags}: exit {rc} in {time.perf_counter() - t:.1f} s, launches "
                f"{n}" + (f"; {err}" if rc else ""))
            torch.cuda.empty_cache()
            return rc, rec, err

        # the gate as a user runs it, a process of its own under the published
        # configs, runs beside the in-process stages (its stages are
        # processes too: a session of their own, killed together on a failure)
        torch.cuda.empty_cache()
        err_path = os.path.join(tmp, "gate.stderr")
        t0 = time.perf_counter()
        with open(err_path, "w") as err_f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "retake_tpu_torch.tools.first_checkpoint_gate"] + argv,
                cwd=root, stdout=subprocess.PIPE, stderr=err_f, text=True, start_new_session=True)
        try:
            total = gate_in_process(argv + ["--config", demo_cfg, "--videomme_config", vm_cfg],
                                    counted, counts)
            sub_out, _ = proc.communicate(timeout=GATE_TIMEOUT_S)
            t_sub = time.perf_counter() - t0
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        with open(err_path) as f:
            sub_err = f.read()[-3000:]
        lines = sub_out.strip().splitlines()
        check(len(lines) == 1, ("gate process stdout", sub_out[-2000:], sub_err))
        sub = json.loads(lines[0])
        log(f"[25] python -m retake_tpu_torch.tools.first_checkpoint_gate (published configs, "
            f"beside the in-process stages): exit {proc.returncode} in {t_sub:.1f} s")
        print(json.dumps({k: brief(v) if isinstance(v, dict) else v for k, v in sub.items()}),
              flush=True)
        errs = {k: v["error"] for k, v in sub.items() if k != "pass" and "error" in v}
        check(tuple(sub) == GATE_KEYS and not errs, ("gate process stages", list(sub), errs))
        check(proc.returncode == (0 if sub["pass"] else 1), ("gate exit code", proc.returncode))

        # the reference's TTFT / TPOT protocol, 2B with random weights
        zero_counts()
        t0 = time.perf_counter()
        rec = cal_ttft.record(["--random-weights", "--frames", str(TTFT_FRAMES), "--runs",
                               str(TTFT_RUNS), "--tpot_tokens", str(TPOT_TOKENS), "--config",
                               demo_cfg, "--device", "cuda"])
        n = read_counts()
        log(f"[25] cal_ttft (2B, random weights, {TTFT_FRAMES} frames, {rec['input_tokens']} "
            f"tokens, attn {rec['attn_implementation']}): TTFT {rec['ttft_s']:.3f} s (runs "
            f"{[round(t, 3) for t in rec['ttft_runs_s']]}), TPOT {rec['tpot_ms']:.2f} ms/token "
            f"({rec['tpot_tokens']} tokens in {rec['tpot_total_s']:.2f} s); launches {n}; {smi}; "
            f"{time.perf_counter() - t0:.1f} s")
        check(math.isfinite(rec["ttft_s"]) and math.isfinite(rec["tpot_ms"])
              and rec["tpot_tokens"] == TPOT_TOKENS, rec)
    torch.cuda.empty_cache()
    return total


# ---------- phase 24: tensor parallelism, two ranks


def tp_rank_main(args) -> int:
    """One rank of phase 24 (``--tp-rank``), a process of its own: joins the
    group (gloo with both ranks on cuda:0, NCCL on cuda:rank when the
    machine has TP_SIZE cards), loads the kernel library phase 2 built (it
    never runs nvcc), and runs (a) Qwen2-VL-7B under SERVING_7B at
    ``--frames``, (b) the TP_SERVE requests through ``ContinuousServer.run``
    with rank 0 leading, (c) LLaVA-Video-7B at TP_LLAVA_FRAMES and a
    ``generate_batch``. Every replicated value is digested and compared
    across the ranks (``tp.check``); the collectives are timed alone
    (``tp.timed``). Writes its tokens, first logits and cache positions to
    ``--tp-out``/rank{r}.npz and a JSON summary to rank{r}.json."""
    import torch.distributed as dist

    from retake_tpu_torch.models.llava_onevision import params as lparams
    from retake_tpu_torch.models.llava_onevision.config import LlavaOnevisionConfig
    from retake_tpu_torch.models.llava_onevision.model import LlavaOnevisionModel
    from retake_tpu_torch.models.qwen2_vl import params as params_lib
    from retake_tpu_torch.models.qwen2_vl.config import qwen2_vl_7b
    from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
    from retake_tpu_torch.ops.cuda import _build
    from retake_tpu_torch.parallel import make_mesh, shard_params
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine, plan_chunks
    from retake_tpu_torch.runtime.llava_engine import LlavaOnevisionEngine
    from retake_tpu_torch.runtime.serve import ContinuousServer
    from retake_tpu_torch.utils.config import RetakeConfig

    t_rank = time.perf_counter()
    rank = args.tp_rank
    tag = f"[24 r{rank}]"
    backend = "nccl" if torch.cuda.device_count() >= TP_SIZE else "gloo"
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    check(_build.library_path().exists(), "phase 2's kernel library is missing")
    _build.library()
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{args.tp_port}",
                            world_size=TP_SIZE, rank=rank)
    tp = make_mesh(dp=1, tp=TP_SIZE, backend=backend).tp
    tp.check = tp.timed = True
    summary = dict(rank=rank, backend=backend, device=str(dev))
    arrays = {}

    def measure(fn):
        """fn() with launches, collective seconds / calls, wall and peak."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        tp.seconds, tp.calls = 0.0, 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, dict(launches=read_counts(), wall_s=wall, collective_s=tp.seconds,
                         collective_calls=tp.calls, collective_share=tp.seconds / wall,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30)

    # (a) Qwen2-VL-7B, the serving config, one request
    cfg7 = qwen2_vl_7b()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full = params_lib.init_params(cfg7, seed=args.seed, device=dev, quantize_int8=True,
                                  quantize_vit_int8=True)
    model = Qwen2VLModel(cfg7, shard_params(full, tp), tp)
    del full
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    summary["weight_gb_7b"] = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    summary["build_peak_gib_7b"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag} {backend} on {dev}; 7B built and sharded in {time.perf_counter() - t0:.1f} s: "
        f"{summary['weight_gb_7b']:.2f} GB of weights on this rank (heads "
        f"{model.num_heads}/{model.num_kv_heads}), build peak {summary['build_peak_gib_7b']:.2f} GiB")
    rt7 = RetakeConfig.from_dict(dict(RETAKE_CONFIG, **SERVING_7B))
    engine = Qwen2VLEngine(cfg7, model, rt7, device=dev, tp=tp)
    ids, patches, grid = build_request(cfg7, args.frames, dev, args.seed)
    ratio = rt7.compression_ratio_for(len(ids))
    plan, final_len, _ = plan_chunks(ids, cfg7.video_token_id, engine.get_chunk_tokens(grid[0]),
                                     ratio, ratio < 1.0)
    res, m = measure(lambda: engine.generate(ids, patches, grid, max_new_tokens=MAX_NEW_TOKENS))
    n = res.cache_fill
    n_video = sum(p["kind"] == "video" for p in plan)
    m.update(ttft_s=res.prefill_seconds, cache_fill=n, plan_steps=len(plan), video_chunks=n_video,
             decode_ms_per_token=1e3 * res.decode_seconds / max(len(res.tokens) - 1, 1))
    summary["request"] = m
    arrays.update(a_tokens=res.tokens, a_first_logits=res.first_logits,
                  a_pos=res.cache.pos[:, :, :n].cpu().numpy())
    la = m["launches"]
    L, vit_chunks = cfg7.num_hidden_layers, -(-int(grid[0][0]) // rt7.frame_chunk_size)
    log(f"{tag} (a) {args.frames} frames: TTFT {res.prefill_seconds:.3f} s, decode "
        f"{m['decode_ms_per_token']:.2f} ms/token, cache {n} (planned {final_len}), collectives "
        f"{m['collective_s']:.3f} s in {m['collective_calls']} calls = "
        f"{100 * m['collective_share']:.1f}% of {m['wall_s']:.3f} s, peak {m['peak_gib']:.2f} GiB; "
        f"launches {la}; tokens {res.tokens[:6].tolist()}")
    check(n == final_len == res.cache_len and res.cache.k.shape[1] == cfg7.num_key_value_heads
          // TP_SIZE and res.cache.quantized, (n, final_len, res.cache.k.shape))
    check(la["K1-int8"] >= L * len(plan) and la["K2"] >= L * n_video
          and la["K3"] >= cfg7.vision.depth * vit_chunks and la["K1"] == la["K4"] == 0
          and la["K4-int8"] == 0, la)
    del res, patches
    torch.cuda.empty_cache()

    # (b) the server: rank 0 reads the clock and broadcasts each event
    reqs, arrivals = [], []
    for i in TP_SERVE:
        frames, arrival, own_max = SERVE_REQUESTS[i]
        r_ids, r_patches, r_grid = build_request(cfg7, frames, dev, args.seed + i)
        req = dict(input_ids=r_ids, pixel_values_videos=r_patches, video_grid_thw=r_grid)
        if own_max is not None:
            req["max_new_tokens"] = own_max
        reqs.append(req)
        arrivals.append(arrival)
    server = ContinuousServer(engine, **SERVE_KW)
    results, m = measure(lambda: server.run(reqs, arrival_times=arrivals))
    n_dec = sum(len(r.tokens) - 1 for r in results)
    m.update(stats=server.stats, tokens_per_s=n_dec / m["wall_s"],
             ttft_s=[r.ttft_s for r in results])
    summary["server"] = m
    for i, r in zip(TP_SERVE, results):
        arrays[f"b_tokens_{i}"] = r.tokens
    lb = m["launches"]
    k4_want = L * SERVE_KW["segment_steps"] * server.stats["segments_dispatched"]
    log(f"{tag} (b) served {len(results)} requests ({[SERVE_REQUESTS[i][0] for i in TP_SERVE]} "
        f"frames) in {m['wall_s']:.3f} s, {m['tokens_per_s']:.2f} tok/s, TTFT "
        f"{[round(t, 3) for t in m['ttft_s']]} s, collectives {100 * m['collective_share']:.1f}%, "
        f"peak {m['peak_gib']:.2f} GiB; stats {json.dumps(server.stats)}; launches {lb}")
    check(lb["K4-int8"] == k4_want and lb["K4"] == 0 and server.stats["compactions"] >= 1
          and all(not r.cancelled for r in results), (lb, k4_want, server.stats))

    # (d) online serving and the HTTP front end on the same engines
    tp_online_http(engine, cfg7, rt7, reqs, tp, args.seed, dev, tag, measure, summary, arrays)
    del server, results, reqs, engine, model
    torch.cuda.empty_cache()

    # (c) LLaVA-Video-7B: frame-sharded SigLIP, K1 / K2 at 14/2 heads
    root = os.path.dirname(os.path.abspath(__file__))
    rt = dataclasses.replace(RetakeConfig.from_yaml(os.path.join(root, LLAVA_YAML)),
                             attn_implementation="pallas")
    rd64 = dataclasses.replace(rt, kv=dataclasses.replace(rt.kv, max_input_length=8000))
    cfg = LlavaOnevisionConfig()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full = lparams.init_params(cfg, seed=args.seed, device=dev)
    lmodel = LlavaOnevisionModel(cfg, shard_params(full, tp), tp)
    del full
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    summary["weight_gb_llava"] = sum(p.numel() * p.element_size() for p in lmodel.parameters()) / 1e9
    summary["build_peak_gib_llava"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag} LLaVA-Video-7B built and sharded in {time.perf_counter() - t0:.1f} s: "
        f"{summary['weight_gb_llava']:.2f} GB on this rank, build peak "
        f"{summary['build_peak_gib_llava']:.2f} GiB")
    leng = LlavaOnevisionEngine(cfg, lmodel, rd64, device=dev, tp=tp)
    ids6, vid6 = llava_request(cfg, TP_LLAVA_FRAMES, dev, args.seed + 1)
    ratio = rd64.compression_ratio_for(len(ids6))
    plan, _, _ = plan_chunks(ids6, cfg.video_token_id, leng.get_chunk_tokens(TP_LLAVA_FRAMES),
                             ratio, ratio < 1.0)
    res, m = measure(lambda: leng.generate(ids6, vid6, max_new_tokens=MAX_NEW_TOKENS))
    n = res.cache_fill
    n_video = sum(p["kind"] == "video" for p in plan)
    m.update(ttft_s=res.prefill_seconds, cache_fill=n, plan_steps=len(plan),
             decode_ms_per_token=1e3 * res.decode_seconds / max(len(res.tokens) - 1, 1))
    summary["llava"] = m
    arrays.update(c_tokens=res.tokens, c_first_logits=res.first_logits,
                  c_pos=res.cache.pos[:, :, :n].cpu().numpy())
    lc = m["launches"]
    Lt = cfg.text.num_hidden_layers
    log(f"{tag} (c) LLaVA {TP_LLAVA_FRAMES} frames: TTFT {res.prefill_seconds:.3f} s, decode "
        f"{m['decode_ms_per_token']:.2f} ms/token, cache {n}, collectives "
        f"{100 * m['collective_share']:.1f}%, peak {m['peak_gib']:.2f} GiB; launches {lc}")
    check(lc["K1"] == Lt * len(plan) and lc["K2"] == Lt * n_video and lc["K3"] == 0
          and lc["K4"] == lc["K1-int8"] == 0 and n == res.cache_len, (lc, len(plan), n_video))
    del res
    reqs = []
    for i, f in enumerate(TP_LLAVA_BATCH):
        r_ids, r_vid = llava_request(cfg, f, dev, args.seed + 30 + i)
        reqs.append(dict(input_ids=r_ids, pixel_values_videos=r_vid))
    batch, m = measure(lambda: leng.generate_batch(reqs, max_new_tokens=MAX_NEW_TOKENS))
    steps = max(len(x.tokens) for x in batch) - 1
    summary["llava_batch"] = m
    for i, x in enumerate(batch):
        arrays[f"c_batch_{i}"] = x.tokens
    lg = m["launches"]
    log(f"{tag} (c) generate_batch {TP_LLAVA_BATCH} frames in {m['wall_s']:.3f} s: launches {lg}")
    check(lg["K4"] >= Lt * steps > 0 and lg["K3"] == 0, (lg, steps))
    del batch, reqs, leng, lmodel
    summary["seconds"] = time.perf_counter() - t_rank
    dist.destroy_process_group()
    np.savez(os.path.join(args.tp_out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(args.tp_out, f"rank{rank}.json"), "w") as f:
        json.dump(summary, f)
    return 0


def _recording(server, served: dict) -> None:
    """Record every result the server emits on this rank, by request id
    (an instance attribute over ``_serve_loop``: followers emit nowhere)."""
    loop = server._serve_loop

    def recorded(source, emit, isolate_errors=False):
        def both(res):
            served[res.request_id] = res
            emit(res)

        return loop(source, both, isolate_errors)

    server._serve_loop = recorded


def _timed_sends(server, tp, sent: list) -> None:
    """Each request's (payload bytes, seconds) as rank 0 sends it or another
    rank receives it (instance attributes over the send and the receive)."""
    for name in ("_send_request", "_recv_request"):
        fn = getattr(server, name)

        def timed(*a, _fn=fn):
            b0, t0 = tp.bytes_broadcast, time.perf_counter()
            out = _fn(*a)
            sent.append((tp.bytes_broadcast - b0, time.perf_counter() - t0))
            return out

        setattr(server, name, timed)


def tp_online_http(engine, cfg, rt, reqs, tp, seed, dev, tag, measure, summary, arrays):
    """Phase 24 (d) on one rank: ``start_online`` on every rank (rank 0
    submits, the others follow), then ``RetakeHTTPServer`` on every rank
    (rank 0 binds 127.0.0.1). Every result each rank emits goes to
    ``arrays`` (the parent holds the ranks bit-equal); rank 0 checks the
    stats, the launches per admission kind, the errors, the HTTP answers,
    and prints the bytes and seconds each request took to reach the other
    ranks and the TTFT of a miss against a hit."""
    import urllib.request

    from retake_tpu_torch.data.processor import Qwen2VLProcessor
    from retake_tpu_torch.eval.synthetic import write_frames
    from retake_tpu_torch.runtime import http_server
    from retake_tpu_torch.runtime.serve import ContinuousServer

    leader, layers, depth = tp.rank == 0, cfg.num_hidden_layers, cfg.vision.depth
    caches = dict(vision_cache_slots=1, prefix_cache_slots=1)
    server = ContinuousServer(engine, **SERVE_KW, **caches)
    served, sent, calls = {}, [], []
    _recording(server, served)
    _timed_sends(server, tp, sent)
    spy_calls(engine, calls)
    keyed = []
    if leader:
        k_ids, k_patches, k_grid = build_request(cfg, 64, dev, seed + 80)
        q2 = np.concatenate([k_ids[:-48], np.random.default_rng(seed + 81).integers(
            10, 1000, size=48)]).astype(np.int64)
        keyed = [dict(input_ids=q, pixel_values_videos=k_patches, video_grid_thw=k_grid,
                      video_key="k", max_new_tokens=TP_D_TOKENS) for q in (k_ids, q2)]
    futs = {}

    def online():
        handle = server.start_online()
        t0 = time.perf_counter()
        try:
            if leader:
                def client(items):
                    for key, req, at in items:
                        time.sleep(max(0.0, at - (time.perf_counter() - t0)))
                        futs[key] = handle.submit(req)

                plan = [[], []]
                for thread, i, at in TP_D_SUBMIT:
                    plan[thread].append((f"serve{i}", dict(reqs[i], max_new_tokens=TP_D_TOKENS),
                                         at))
                plan[1] += [("miss", keyed[0], 2.5), ("hit", keyed[1], 3.0),
                            ("bad", {"input_ids": "not-an-array"}, 3.5),
                            ("late", dict(keyed[1], deadline_s=0.0), 4.0)]
                threads = [threading.Thread(target=client, args=(items,)) for items in plan]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(WAIT_S)
                    check(not t.is_alive(), "a submitting thread hung")
                for f in futs.values():
                    f.result(timeout=WAIT_S)
        finally:
            handle.close(timeout=WAIT_S)
        check(not handle._thread.is_alive() and handle.error is None, ("worker", handle.error))

    _, m = measure(online)
    for name in ("generate", "encode_prefix", "encode_video"):
        del engine.__dict__[name]
    st = dict(server.stats)
    kinds = {}
    for kind, n in calls:
        kinds.setdefault(kind, []).append({k: v for k, v in n.items() if v})
    m.update(stats=st, sent=sent, kinds=kinds)
    for rid, res in served.items():
        arrays[f"d_online_{rid}"] = res.tokens
    log(f"{tag} (d) online: {len(served)} results in {m['wall_s']:.3f} s, collectives "
        f"{100 * m['collective_share']:.1f}%; stats {json.dumps(st)}; launches {m['launches']}")
    log(f"{tag} (d) requests sent to the other ranks (bytes, s): "
        + ", ".join(f"({b}, {s:.3f})" for b, s in sent))
    log(f"{tag} (d) launches per admission kind: {json.dumps(kinds)}")
    want = {"requests_failed": 1, "requests_rejected_deadline": 1, "vision_cache_hits": 1,
            "vision_cache_misses": 1, "prefix_cache_hits": 1, "prefix_cache_misses": 1,
            "requests_finished": len(TP_D_SUBMIT) + 2, "requests_cancelled": 0}
    check(all(st[k] == v for k, v in want.items()), (st, want))
    # encode_video: the keyed miss's, and the one inside each inline request
    check(len(kinds.get("prefix", [])) == 2 and len(kinds.get("encode_prefix", [])) == 1
          and len(kinds.get("inline", [])) == len(TP_D_SUBMIT)
          and len(kinds.get("encode_video", [])) == 1 + len(TP_D_SUBMIT),
          {k: len(v) for k, v in kinds.items()})
    for n in kinds["prefix"]:  # one text step over the captured int8 cache
        check(n.get("K1-int8") == layers and "K2" not in n and "K3" not in n, ("prefix", n))
    for n in kinds["encode_video"]:  # one ViT chunk (64 or 128 frames)
        check(n.get("K3") == depth and "K1-int8" not in n, ("encode_video", n))
    summary["online"] = m
    if leader:
        res = {k: f.result(timeout=0) for k, f in futs.items()}
        check(res["bad"].error and res["bad"].cancelled and not len(res["bad"].tokens), res["bad"])
        check(res["late"].cancelled and not len(res["late"].tokens), res["late"])
        for key in ("miss", "hit"):
            check(len(res[key].tokens) == TP_D_TOKENS and not res[key].cancelled, res[key])
        agree = total = 0
        for _, i, _ in TP_D_SUBMIT:  # against the start of (b)'s run() stream
            a, b = res[f"serve{i}"].tokens, arrays[f"b_tokens_{TP_SERVE[i]}"][:TP_D_TOKENS]
            k = min(len(a), len(b))
            agree += int(np.sum(a[:k] == b[:k]))
            total += max(len(a), len(b))
        log(f"{tag} (d) online streams vs (b)'s: agreement {agree / total:.4f} (bound "
            f"{TP_MIN_AGREEMENT})")
        check(agree / total >= TP_MIN_AGREEMENT, agree / total)
        summary["online_prefill"] = {k: res[k].first_token_s - res[k].prefill_start_s
                                     for k in ("miss", "hit")}
        summary["online_agreement"] = agree / total
        log(f"{tag} (d) keyed video: miss TTFT {res['miss'].ttft_s:.3f} s, of it its admission "
            f"{summary['online_prefill']['miss']:.3f} s (ViT, capture); hit TTFT "
            f"{res['hit'].ttft_s:.3f} s, admission {summary['online_prefill']['hit']:.3f} s (one "
            f"text step); the rest is the queue behind (b)'s requests; {len(sent)} requests "
            f"sent, {sum(b for b, _ in sent) / 1e6:.1f} MB in {sum(s for _, s in sent):.3f} s")

    # HTTP: rank 0 binds and loads the frames; the other ranks follow
    proc = None
    if leader:
        proc = Qwen2VLProcessor(ByteTokenizer(), vision_start_token_id=cfg.vision_start_token_id,
                                vision_end_token_id=cfg.vision_end_token_id,
                                video_token_id=cfg.video_token_id,
                                image_token_id=cfg.image_token_id)
    srv = http_server.RetakeHTTPServer(engine, proc, rt, host="127.0.0.1", port=0, **SERVE_KW,
                                       **caches)
    http_served, http_sent, out = {}, [], {}
    _recording(srv.server, http_served)
    _timed_sends(srv.server, tp, http_sent)
    loads = {"n": 0}
    fetch = http_server.fetch_video

    def counting_fetch(*a, **kw):
        loads["n"] += 1
        return fetch(*a, **kw)

    http_server.fetch_video = counting_fetch

    def post(body):
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/v1/generate",
                                     data=json.dumps(body).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            raw, ctype = r.read(), r.headers["Content-Type"]
        if ctype.startswith("text/event-stream"):
            return [json.loads(x[6:]) for x in raw.split(b"\n\n") if x.startswith(b"data: ")]
        return json.loads(raw)

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=WAIT_S) as r:
            return json.loads(r.read())

    def http():
        with tempfile.TemporaryDirectory(prefix="retake_tp_frames_") as frames:
            if leader:
                write_frames(frames, HTTP_FRAMES, 448, 252, seed + 90, block=4)
            body = {"question": "What happens in the video? Answer with the option's letter.",
                    "video_path": frames, "extraction_fps": rt.sample_fps,
                    "max_new_tokens": TP_D_TOKENS}
            srv.start()
            try:
                if leader:
                    out["health"] = get("/healthz")
                    c0 = read_counts()
                    out["miss"] = post(body)
                    c1 = read_counts()
                    out["hit"] = post(body)
                    c2 = read_counts()
                    out["stream"] = post(dict(body, stream=True))
                    out["metrics"] = get("/metrics")
                    out["n_miss"] = {k: c1[k] - c0[k] for k in c1}
                    out["n_hit"] = {k: c2[k] - c1[k] for k in c2}
            finally:
                srv.shutdown(timeout=WAIT_S)
                http_server.fetch_video = fetch

    _, m = measure(http)
    check(srv.handle is None and not srv.server._slot_req, "the HTTP server did not stop")
    m.update(stats=dict(srv.server.stats), sent=http_sent)
    for rid, res in http_served.items():
        arrays[f"d_http_{rid}"] = res.tokens
    summary["http"] = m
    log(f"{tag} (d) HTTP: {len(http_served)} results in {m['wall_s']:.3f} s; stats "
        f"{json.dumps(m['stats'])}; requests sent (bytes, s): "
        + ", ".join(f"({b}, {s:.3f})" for b, s in http_sent))
    if leader:
        miss, hit, stream = out["miss"], out["hit"], out["stream"]
        streamed = [t for e in stream if not e.get("done") for t in e["tokens"]]
        log(f"{tag} (d) HTTP miss TTFT {miss['ttft_s']:.3f} s, launches "
            f"{ {k: v for k, v in out['n_miss'].items() if v} }; prefix hit TTFT "
            f"{hit['ttft_s']:.3f} s, launches { {k: v for k, v in out['n_hit'].items() if v} }; "
            f"stream {len(stream) - 1} chunks; frame loads {loads['n']}")
        check(out["health"]["ok"] and loads["n"] == 1, (out["health"], loads))
        for r in (miss, hit, stream[-1]):
            check(len(r["tokens"]) == TP_D_TOKENS and not r["cancelled"] and "error" not in r, r)
        check(streamed == stream[-1]["tokens"] and stream[-1]["done"], "stream vs done event")
        check(out["n_miss"]["K3"] > 0 and out["n_hit"]["K3"] == 0
              and out["n_hit"]["K1-int8"] == layers and out["n_hit"]["K2"] == 0,
              (out["n_miss"], out["n_hit"]))
        check(out["metrics"]["prefix_cache_hits"] == 2 and out["metrics"]["requests_finished"] == 3,
              out["metrics"])
        summary["http_ttft"] = {"miss": miss["ttft_s"], "hit": hit["ttft_s"]}
    del srv, server
    torch.cuda.empty_cache()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _pos_agreement(a: np.ndarray, b: np.ndarray) -> float:
    """``kept_agreement`` over two caches' position arrays [L, 3, n]."""
    n = min(a.shape[2], b.shape[2])
    return kept_agreement(types.SimpleNamespace(pos=torch.from_numpy(a)),
                          types.SimpleNamespace(pos=torch.from_numpy(b)), n)


def phase_tp(args, refs: dict) -> dict:
    """Phase 24: spawn TP_SIZE ranks of this script (``tp_rank_main``), wait
    for both (any rank's failure fails the phase; a rank past
    TP_TIMEOUT_S is killed), then hold them to each other bit for bit
    (tokens, first logits, cache positions) and to the tp = 1 runs of the
    same seeds and weights: (a) phase 10's first logits and kept entries,
    (b) phase 11's streams of the same requests, (c) phase 22's 64-frame
    kernel-path request. Returns the launches by path (rank 0's; each rank
    launches the same kernels)."""
    out_dir = tempfile.mkdtemp(prefix="retake_tp_")
    port = _free_port()
    script = os.path.abspath(__file__)
    procs, logs = [], []
    for r in range(TP_SIZE):
        lf = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        logs.append(lf)
        procs.append(subprocess.Popen(
            [sys.executable, script, "--tp-rank", str(r), "--tp-port", str(port), "--tp-out",
             out_dir, "--frames", str(args.frames), "--seed", str(args.seed)],
            stdout=lf, stderr=subprocess.STDOUT, cwd=os.path.dirname(script)))
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, TP_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lf in logs:
            lf.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        with open(os.path.join(out_dir, f"rank{r}.log")) as f:
            text = f.read()
        lines = text.splitlines()
        shown = [ln for ln in lines if ln.startswith("[24 ")] if p.returncode == 0 else lines[-60:]
        for ln in shown:
            log(ln)
        check(p.returncode == 0, (f"rank {r} exited with {p.returncode}", wall))
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(TP_SIZE)]
    summ = []
    for r in range(TP_SIZE):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            summ.append(json.load(f))
    same = {k: all(np.array_equal(x[k], ranks[0][k]) for x in ranks) for k in ranks[0]}
    log(f"[24] {TP_SIZE} ranks ({summ[0]['backend']}) in {wall:.1f} s; ranks bit-identical: {same}")
    check(all(same.values()), same)
    for part in ("request", "server", "online", "http", "llava", "llava_batch"):
        check(all(s[part]["launches"] == summ[0][part]["launches"] for s in summ),
              (part, [s[part]["launches"] for s in summ]))
    for part in ("online", "http"):  # stats, and the bytes each request brought
        check(all(s[part]["stats"] == summ[0][part]["stats"]
                  and [b for b, _ in s[part]["sent"]] == [b for b, _ in summ[0][part]["sent"]]
                  for s in summ), (part, [(s[part]["stats"], s[part]["sent"]) for s in summ]))
    d_keys = sorted(k for k in ranks[0] if k.startswith("d_"))
    d0 = summ[0]
    sent = d0["online"]["sent"] + d0["http"]["sent"]
    log(f"[24] (d) online and HTTP under TP: {len(d_keys)} results bit-equal on the "
        f"{TP_SIZE} ranks; keyed video admission miss {d0['online_prefill']['miss']:.3f} s / "
        f"hit {d0['online_prefill']['hit']:.3f} s; HTTP TTFT miss "
        f"{d0['http_ttft']['miss']:.3f} s / hit {d0['http_ttft']['hit']:.3f} s; {len(sent)} "
        f"requests sent, largest "
        f"{max(b for b, _ in sent) / 1e6:.1f} MB in {max(t for _, t in sent):.3f} s, all "
        f"{sum(b for b, _ in sent) / 1e6:.1f} MB in {sum(t for _, t in sent):.3f} s; online "
        f"{d0['online']['wall_s']:.1f} s, HTTP {d0['http']['wall_s']:.1f} s; agreement with "
        f"(b) {d0['online_agreement']:.4f}")
    check(len(d_keys) == len(sent),
          ("every admitted request's result on every rank", d_keys))
    r0 = ranks[0]
    a_ref, c_ref = refs.get("10"), refs.get("22")
    if a_ref is not None:
        rel = float(np.abs(r0["a_first_logits"] - a_ref["first_logits"]).max()
                    / np.abs(a_ref["first_logits"]).max())
        kept = _pos_agreement(r0["a_pos"], a_ref["pos"])
        log(f"[24] (a) tp = {TP_SIZE} vs tp = 1 (phase 10): first logits rel max|diff| {rel:.3e} "
            f"(bound {TP_REL_LOGIT_TOL}), kept entries in common {kept:.4f} (bound "
            f"{E2E7_MIN_KEPT_AGREEMENT}); cache {r0['a_pos'].shape[2]} vs {a_ref['pos'].shape[2]}; "
            f"tokens {r0['a_tokens'][:6].tolist()} / {a_ref['tokens'][:6].tolist()}")
        check(r0["a_pos"].shape == a_ref["pos"].shape, "cache fill")
        check(rel <= TP_REL_LOGIT_TOL and kept >= E2E7_MIN_KEPT_AGREEMENT, (rel, kept))
    if refs.get("11") is not None:
        agree = total = 0
        for i in TP_SERVE:
            a, b = r0[f"b_tokens_{i}"], refs["11"][i]
            k = min(len(a), len(b))
            agree += int(np.sum(a[:k] == b[:k]))
            total += max(len(a), len(b))
        log(f"[24] (b) served tokens vs phase 11's streams: agreement {agree / total:.4f} (bound "
            f"{TP_MIN_AGREEMENT})")
        check(agree / total >= TP_MIN_AGREEMENT, agree / total)
    if c_ref is not None:
        rel = float(np.abs(r0["c_first_logits"] - c_ref["first_logits"]).max()
                    / np.abs(c_ref["first_logits"]).max())
        kept = _pos_agreement(r0["c_pos"], c_ref["pos"])
        log(f"[24] (c) LLaVA tp = {TP_SIZE} vs tp = 1 (phase 22, 64 frames): first logits rel "
            f"max|diff| {rel:.4f} (bound {LLAVA_REL_LOGIT_TOL}), kept entries in common "
            f"{kept:.4f} (bound {LLAVA_MIN_KEPT})")
        check(r0["c_pos"].shape == c_ref["pos"].shape, "LLaVA cache fill")
        check(rel <= LLAVA_REL_LOGIT_TOL and kept >= LLAVA_MIN_KEPT, (rel, kept))
    for s_ in summ:
        a, b, c = s_["request"], s_["server"], s_["llava"]
        log(f"[24] rank {s_['rank']} ({s_['backend']}, {s_['device']}): request TTFT "
            f"{a['ttft_s']:.3f} s, decode {a['decode_ms_per_token']:.2f} ms/token, peak "
            f"{a['peak_gib']:.2f} GiB, collectives {100 * a['collective_share']:.1f}% of wall; "
            f"server {b['tokens_per_s']:.2f} tok/s, collectives {100 * b['collective_share']:.1f}%; "
            f"LLaVA TTFT {c['ttft_s']:.3f} s, collectives {100 * c['collective_share']:.1f}%; "
            f"rank wall {s_['seconds']:.1f} s")
    return {"24 request": summ[0]["request"]["launches"],
            "24 server": summ[0]["server"]["launches"],
            "24 online": summ[0]["online"]["launches"],
            "24 http": summ[0]["http"]["launches"],
            "24 llava": {k: summ[0]["llava"]["launches"][k] + summ[0]["llava_batch"]["launches"][k]
                         for k in summ[0]["llava"]["launches"]}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=512, help="raw video frames (2048 = bench)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="profile one more warm request and decode step")
    ap.add_argument("--llava-frames", type=int, default=256,
                    help="phase 22's LLaVA-Video request (1024 = the published config)")
    # phase 24 starts this script again as each of its ranks
    ap.add_argument("--tp-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-out", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()

    # 1. device and environment
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA GPU",
              file=sys.stderr)
        return 2
    if args.tp_rank is not None:
        return tp_rank_main(args)
    from retake_tpu_torch.models.qwen2_vl import params as params_lib
    from retake_tpu_torch.models.qwen2_vl.config import qwen2_vl_2b, qwen2_vl_7b
    from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
    from retake_tpu_torch.ops.cuda import _build
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

    # the processes this script starts (phases 23-25) share one bytecode
    # cache: where site-packages hold no .pyc, each would compile torch's and
    # transformers' sources again (~10 s a process on the H100 host, PERF.md §6)
    os.environ["PYTHONPYCACHEPREFIX"] = str(_build.BUILD_DIR / "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'} s)")

    # 3. kernels vs plain twins
    log(f"[3] bounds against the published H100 SXM dense peaks ({PEAK_BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s bf16, {PEAK_BYTES_PER_S / 1e12:.2f} TB/s) on {smi}")
    records = {}
    phase_kernels(dev, records)
    phase_kernels_int8(dev, records)
    phase_kernels_new_shapes(dev, records)
    phase_kernels_llava(dev, records)
    phase_kernels_tp_shapes(dev, records)
    log("[3] kernels match their plain versions")

    # 4-6. 2B in bf16: one request, its repeat, kernel vs plain path
    cfg = qwen2_vl_2b()
    t0 = time.perf_counter()
    model = Qwen2VLModel(cfg, params_lib.init_params(cfg, seed=args.seed, device=dev))
    torch.cuda.synchronize()
    log(f"[4] 2B model built in {time.perf_counter() - t0:.1f} s")
    rt = RetakeConfig.from_dict(RETAKE_CONFIG)
    launches = phase_request(cfg, model, RETAKE_CONFIG, dev, args, ("4", "5", "6"),
                             E2E_REL_LOGIT_TOL, E2E_MIN_KEPT_AGREEMENT)

    # 7. the continuous-batching server: six staggered requests, 4 slots
    # [0]: the launches; the returned requests would keep their patches on the card
    serve_launches = phase_serve(cfg, model, rt, dev, args.seed)[0]
    torch.cuda.empty_cache()

    # 8. one batched decode step over three real prefills, kernel vs plain
    phase_decode_step(cfg, model, rt, dev, args.seed, args.profile)

    # 9. weight-only int8 against bf16 on the same 2B weights
    phase_weight_only(cfg, model, dev, args.seed)

    # 12-16. the per-question paths on the same 2B model: prompt-guided
    # compression, images, reuse across questions, speculative decode,
    # sampling. Each path's launches are read around it
    t_new = time.perf_counter()
    paths = {"4": launches, "7": serve_launches}
    rd12 = json.loads(json.dumps(RETAKE_CONFIG))
    rd12["longvideo_kwargs"]["kvcache_compression_kwargs"]["prompt_guided_compression"] = True
    paths["12"] = phase_request(cfg, model, rd12, dev, args, ("12", "12", "12"),
                                E2E_REL_LOGIT_TOL, E2E_MIN_KEPT_AGREEMENT)
    paths["13"] = phase_images(cfg, model, dev, args.seed)
    phase_reuse(cfg, model, RETAKE_CONFIG, dev, args.frames, args.seed, "14", features=True)
    greedy, paths["15"] = phase_spec(cfg, model, dev, args)
    paths["16 generate_batch"], paths["16 server"] = phase_sampling(cfg, model, dev, args, greedy)
    t_new = time.perf_counter() - t_new
    log(f"[12-16] per-question paths: {t_new:.1f} s")

    # 17-20. the rest of serving (online mode with both caches, HTTP), the
    # "flash" attention arm, MA-LLM compression; each path's launches are
    # read around it
    t_rest, walls = time.perf_counter(), []
    paths["17"] = phase_online(cfg, model, dev, args.seed)
    walls.append(time.perf_counter())
    paths["18"] = phase_http(cfg, model, dev, args.seed)
    walls.append(time.perf_counter())
    flash = phase_flash(cfg, model, dev, args)
    paths["19"], paths["19 generate_batch"] = flash["request"], flash["generate_batch"]
    walls.append(time.perf_counter())
    for tag, n in phase_malm(cfg, model, dev, args.seed).items():
        paths[f"20 {tag}"] = n
    walls.append(time.perf_counter())
    each = np.diff([t_rest] + walls)
    t_rest = walls[-1] - t_rest
    log(f"[17-20] serving, flash, MA-LLM: {t_rest:.1f} s (" + ", ".join(
        f"{p}: {w:.1f} s" for p, w in zip(range(17, 21), each)) + ")")

    # 21. weights, configs and the demo from disk (2B); 23. the eval runner,
    # the quantizer over the same HF checkpoint directory, the host pipeline
    with tempfile.TemporaryDirectory() as hf_dir:
        t21 = time.perf_counter()
        paths["21 demo"] = phase_loading(cfg, model, dev, args.seed, hf_dir)
        t21 = time.perf_counter() - t21
        log(f"[21] loading and the demo: {t21:.1f} s")
        del model
        torch.cuda.empty_cache()
        t23 = time.perf_counter()
        paths["23 eval"] = phase_eval(cfg, dev, args.seed, hf_dir)
        t23 = time.perf_counter() - t23
        log(f"[23] eval, quantizer, host pipeline: {t23:.1f} s")
        # 25. the first-checkpoint gate over the same checkpoint, cal_ttft
        t25 = time.perf_counter()
        paths["25 gate"] = phase_gate(args.seed, hf_dir, smi)
        t25 = time.perf_counter() - t25
        log(f"[25] first-checkpoint gate and cal_ttft: {t25:.1f} s")

    # 10-11. 7B at full width and depth in the serving configuration: W8A8
    # linears and the int8 KV cache. init_params quantizes on the device,
    # stack by stack as it draws (quantize_llm_int8 / quantize_vit_int8's
    # quantizers), so the bf16 7B tree never exists whole
    cfg7 = qwen2_vl_7b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model7 = Qwen2VLModel(cfg7, params_lib.init_params(
        cfg7, seed=args.seed, device=dev, quantize_int8=True, quantize_vit_int8=True))
    torch.cuda.synchronize()
    weight_gb = sum(p.numel() * p.element_size() for p in model7.parameters()) / 1e9
    log(f"[10] 7B model built (int8 LLM and ViT linears) in {time.perf_counter() - t0:.1f} s: "
        f"{weight_gb:.2f} GB of weights, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rd7 = dict(RETAKE_CONFIG, **SERVING_7B)
    tp_refs = {"10": {}, "22": {}}
    launches7 = phase_request(cfg7, model7, rd7, dev, args, ("10", "10", "10"),
                              E2E7_REL_LOGIT_TOL, E2E7_MIN_KEPT_AGREEMENT, ref=tp_refs["10"])
    serve7, streams7 = phase_serve(cfg7, model7, RetakeConfig.from_dict(rd7), dev, args.seed,
                                   tag="11")
    tp_refs["11"] = [tokens for _, tokens in streams7]  # host arrays; the requests go
    del streams7
    paths.update({"10": launches7, "11": serve7})
    # 14 (7B): the prefix of a 64-frame video in the serving config (int8 KV)
    phase_reuse(cfg7, model7, rd7, dev, 64, args.seed, "14 7B", features=False)
    del model7
    torch.cuda.empty_cache()

    # 22. LLaVA-Video-7B at full width and depth
    t22 = time.perf_counter()
    paths.update(phase_llava(dev, args, ref=tp_refs["22"]))
    t22 = time.perf_counter() - t22
    log(f"[22] LLaVA-Video-7B: {t22:.1f} s")

    # 24. tensor parallelism: two ranks of 7B (request, server) and of
    # LLaVA-Video-7B, held to each other and to phases 10, 11 and 22
    torch.cuda.empty_cache()
    t24 = time.perf_counter()
    paths.update(phase_tp(args, tp_refs))
    t24 = time.perf_counter() - t24
    log(f"[24] tensor parallelism: {t24:.1f} s")

    # the kernels line: K1-K3 from the 2B request (phase 4), K4 from the 2B
    # server (phase 7), K1-int8 from the 7B request (phase 10), K4-int8 from
    # the 7B server (phase 11)
    source = {"K1": launches, "K2": launches, "K3": launches, "K4": serve_launches,
              "K1-int8": launches7, "K4-int8": serve7}
    kernel_line = {"kernels": [
        dict(records[key], launches=source[key][key],
             launches_by_path={tag: n[key] for tag, n in paths.items()})
        for key in ("K1", "K1-int8", "K2", "K3", "K4", "K4-int8")
    ]}
    log(f"[end] chip_smoke.py wall time {time.perf_counter() - t_start:.1f} s (phases 12-16 "
        f"{t_new:.1f} s, 17-20 {t_rest:.1f} s, 21 {t21:.1f} s, 22 {t22:.1f} s, 23 {t23:.1f} s, "
        f"24 {t24:.1f} s, 25 {t25:.1f} s)")
    log(smi)
    print(json.dumps(kernel_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
