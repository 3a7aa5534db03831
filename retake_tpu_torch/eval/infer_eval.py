"""Distributed benchmark runner (VideoMME / MLVU / LVBench), port of
``retake_tpu/eval/infer_eval.py``.

The reference's eval runner (retake/infer_eval.py:118-229) spawns one
process per GPU, round-robin shards the dataset and merges with
``dist.all_gather_object``. Here, as in the JAX runner:

* processes: one per GPU. With ``--coordinator host:port`` every process
  joins a ``torch.distributed`` group (``gloo``: the runner needs only a
  barrier) and drives ``cuda:{process_id % device_count}``; ``--device
  cpu`` runs on the CPU.
* sharding: the same ``i % world == rank`` round-robin (by video under
  ``reuse_video_features``).
* result merge: per-rank JSONL shard files + a barrier, then rank 0 merges
  and scores.
* incremental journaling: each completed sample is appended to the rank
  shard at once, so a crashed run resumes where it stopped. The journal
  format is the JAX runner's: either runner resumes a shard the other
  wrote.

Outputs are the reference's artifacts: anno_id2result.json,
infer_results.csv, eval_results.csv in ``output_dir``.

Usage:
  python3 -m retake_tpu_torch.eval.infer_eval --hf_path /ckpt/Qwen2-VL-7B \\
      --config_path configs/qwen2_vl/retake_qwen2-vl_videomme.yaml \\
      [--coordinator 127.0.0.1:29500 --num_processes 2 --process_id 0]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from retake_tpu_torch import device as device_lib


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="ReTaKe evaluation (PyTorch port)")
    p.add_argument("--model_name", type=str, default=None)
    p.add_argument("--hf_path", "--hf_qwen2vl7b_path", type=str, required=True,
                   help="HF checkpoint directory (config.json + safetensors)")
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--video_frame_extraction_fps", type=int, default=25)
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of the torch.distributed rendezvous")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument(
        "--resume", action=argparse.BooleanOptionalAction, default=True,
        help="skip samples already in this rank's shard journal "
             "(--no-resume re-runs everything; stale journals otherwise "
             "suppress re-runs silently)",
    )
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the process's card) or 'cpu'")
    return p.parse_args(argv)


def _init_distributed(args):
    if args.coordinator:
        import torch.distributed as dist

        dist.init_process_group(
            "gloo", init_method=f"tcp://{args.coordinator}",
            world_size=args.num_processes, rank=args.process_id,
        )
        return dist.get_rank(), dist.get_world_size()
    return args.process_id, args.num_processes


def process_device(device, process_id: int) -> torch.device:
    """The device a process drives: ``cuda`` means the process's own card,
    ``cuda:{process_id % device_count}``."""
    dev = device_lib.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def _model_key(model_name) -> str:
    return model_name.lower().replace("-", "").replace("_", "")


def _load_engine(model_name, hf_path, rt, device):
    from retake_tpu_torch.models.qwen2_vl import params as params_lib
    from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig
    from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
    from retake_tpu_torch.ops import quantization as q8
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine
    from retake_tpu_torch.utils import checkpoint

    name = _model_key(model_name or rt.model_name)
    if name == "qwen2vl":
        cfg = Qwen2VLConfig.from_pretrained(hf_path)
        if checkpoint.has_params(hf_path):
            # pre-quantized tree (tools/quantize_checkpoint.py): skip the
            # bf16-sized read and the on-device quantization pass
            params = checkpoint.load_checked(hf_path, rt, "qwen2_vl", device=device)
        else:
            params = params_lib.load_safetensors(hf_path, cfg, device=device)
            if rt.quantization in ("int8", "w8a8"):
                params = q8.quantize_llm_int8(params)
            if rt.quantization == "w8a8":
                params["visual"] = q8.quantize_vit_int8(params["visual"])
        return Qwen2VLEngine(cfg, Qwen2VLModel(cfg, params), rt, device=device)
    if name in ("llavaonevision", "llavavideo"):
        from retake_tpu_torch.runtime.llava_engine import load_llava_engine

        return load_llava_engine(hf_path, rt, device=device)
    raise NotImplementedError(name)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    rank, world = _init_distributed(args)
    dev = process_device(args.device, args.process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    from retake_tpu_torch.data.datasets import get_dataset
    from retake_tpu_torch.data.processor import Qwen2VLProcessor
    from retake_tpu_torch.utils.config import RetakeConfig

    rt = RetakeConfig.from_yaml(args.config_path)
    engine = _load_engine(args.model_name, args.hf_path, rt, dev)
    if _model_key(args.model_name or rt.model_name) in ("llavaonevision", "llavavideo"):
        from retake_tpu_torch.data.processor import LlavaOnevisionVideoProcessor

        processor = LlavaOnevisionVideoProcessor.from_pretrained(
            args.hf_path,
            video_token_id=engine.cfg.video_token_id,
            image_size=engine.cfg.vision.image_size,
            tokens_per_frame=engine.cfg.tokens_per_frame,
        )
    else:
        processor = Qwen2VLProcessor.from_pretrained(args.hf_path)

    dataset = get_dataset(
        rt.dataset_name,
        rt.anno_file,
        processor_kwargs=dict(
            video_fps=rt.sample_fps,
            video_maxlen=rt.max_num_frames,
            image_resolution=rt.longsize_resolution,
            video_frame_extraction_fps=args.video_frame_extraction_fps,
        ),
    )

    run_eval(engine, processor, dataset, rt, rank, world, resume=args.resume)
    _barrier(args)
    if rank == 0:
        merge_and_score(rt, world)
    return 0


def prefetch_iter(indices, load_fn, num_workers: int):
    """Yield (idx, load_fn(idx)) with up to ``num_workers`` loads running in
    background threads, pipelined ``depth`` samples ahead.

    The device work of a sample leaves the host idle for most of its time;
    threads decode the next samples' JPEG frames in that window, as the
    reference's ``DataLoader(num_workers=...)`` does (retake/infer_eval.py:
    184). ``num_workers<=0`` falls back to serial. Results come back in
    order (answer parity with the serial loop).
    """
    if num_workers <= 0:
        for idx in indices:
            yield idx, load_fn(idx)
        return
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    depth = num_workers + 1
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        pending = deque()
        it = iter(indices)
        for idx in indices[:depth]:
            pending.append((idx, ex.submit(load_fn, idx)))
            next(it)
        while pending:
            idx, fut = pending.popleft()
            nxt = next(it, None)
            if nxt is not None:
                pending.append((nxt, ex.submit(load_fn, nxt)))
            yield idx, fut.result()


def run_eval(engine, processor, dataset, rt, rank, world, resume=True):
    """Round-robin shard loop with per-sample journaling (resumable)."""
    from retake_tpu_torch.data.scorers import trim_answer

    out_dir = rt.output_dir or "results/eval"
    os.makedirs(out_dir, exist_ok=True)
    shard_file = os.path.join(out_dir, f"shard_{rank:03d}.jsonl")

    done: Dict[int, str] = {}
    if resume and os.path.exists(shard_file):
        with open(shard_file) as f:
            for line in f:
                rec = json.loads(line)
                done[rec["idx"]] = rec["answer"]
        print(f"[rank {rank}] resuming: {len(done)} samples already done")

    reuse = bool(rt.reuse_video_features)
    if reuse:
        # shard round-robin BY VIDEO so one process owns all of a video's
        # questions and encodes the vision stage once (VideoFeatures). The
        # reference round-robins by sample (infer_eval.py:181-182): the
        # assignment differs but the merged artifacts are identical (the
        # merge is idx-keyed and every sample runs exactly once).
        order: Dict[str, int] = {}
        groups_by_vid: Dict[str, list] = {}
        for i in range(len(dataset)):
            key = dataset.video_key(i)
            if key not in order:
                order[key] = len(order)
            groups_by_vid.setdefault(key, []).append(i)
        groups = [
            [i for i in members if i not in done]
            for key, members in groups_by_vid.items()
            if order[key] % world == rank
        ]
        groups = [g for g in groups if g]
        indices = [i for g in groups for i in g]
    else:
        indices = [
            i for i in range(len(dataset))
            if i % world == rank and i not in done
        ]

    def load(idx):
        i, message, meta = dataset[idx]
        inputs = processor(message["question"], message["video"])
        return i, message, meta, inputs

    bs = max(1, int(rt.eval_batch_size))
    # batched sampling is safe: draws derive from (seed, request-own step),
    # the sequential loop's schedule, so answers don't depend on batch
    # packing or resume boundaries (engine.generate_batch)
    t_start = time.time()
    n_done = 0
    with open(shard_file, "a") as journal:

        def journal_one(sample, result, extra_metrics=None):
            nonlocal n_done
            i, message, meta = sample
            answer = trim_answer(processor.decode(result.tokens))
            meta = dict(meta)
            meta["question"] = meta.get("question", message["question"])
            journal.write(json.dumps({
                "idx": i,
                "answer": answer,
                "meta": _json_safe(meta),
                "metrics": {
                    "prefill_s": round(result.prefill_seconds, 3),
                    "decode_s": round(result.decode_seconds, 3),
                    "input_tokens": int(result.input_len),
                    "cache_tokens": int(result.cache_len),
                    "new_tokens": int(len(result.tokens)),
                    **(extra_metrics or {}),
                },
            }) + "\n")
            journal.flush()
            done[i] = answer
            n_done += 1
            if n_done % 10 == 1:
                rate = n_done / (time.time() - t_start)
                print(f"[rank {rank}] {n_done}/{len(indices)} ({rate:.2f}/s)")

        # (sample_meta, PrefillState) accumulated up to eval_batch_size,
        # grouped by decode bucket (PrefillState.attn_need): batched decode
        # runs the whole batch at its largest member's attention bucket, so
        # a short request batched with a long one would pay the long one's
        # cache sweep every step. Each sample is prefilled as it arrives so
        # its decoded pixel arrays are dropped at once; only the device KV
        # caches, trimmed to each request's own bucket, accumulate.
        pending: Dict[int, list] = {}
        extras_by_idx: Dict[int, dict] = {}

        def flush_batch(bucket):
            group = pending.pop(bucket, [])
            if not group:
                return
            from retake_tpu_torch.runtime.engine import decode_batch

            samples, states = zip(*group)
            # the plain batched-decode arm, as the JAX runner's decode_batch
            results = decode_batch(
                engine.model, getattr(engine.cfg, "text", engine.cfg),
                rt, list(states), rt.max_new_tokens,
                early_stop=bool(rt.decode_early_stop),
            )
            for sample, res in zip(samples, results):
                journal_one(sample, res, extras_by_idx.pop(sample[0], None))

        def dispatch_one(sample, gen_kwargs, extras=None):
            """One sample through generate: direct at bs==1, else prefill
            into the per-bucket pending batch (shared by the per-sample and
            the reuse-grouped loops)."""
            if bs == 1:
                result = engine.generate(
                    **gen_kwargs, max_new_tokens=rt.max_new_tokens
                )
                journal_one(sample, result, extras)
                return
            state = engine.generate(
                **gen_kwargs, max_new_tokens=rt.max_new_tokens,
                _prefill_only=True,
            )
            if extras:
                extras_by_idx[sample[0]] = extras
            pending.setdefault(state.attn_need, []).append((sample, state))
            if len(pending[state.attn_need]) >= bs:
                flush_batch(state.attn_need)

        if reuse:
            # one vision encode per video; each question reuses the
            # VideoFeatures artifact. Frames load once per video (leader =
            # the group's first pending sample); other questions re-tokenize
            # text-only (processor video_grid / num_frames modes).
            def load_group(gi):
                i, message, meta = dataset[groups[gi][0]]
                inputs = processor(message["question"], message["video"])
                return i, message, meta, inputs

            from retake_tpu_torch.runtime.engine import (
                PrefixMismatch,
                PrefixUnsupported,
            )

            # reuse-outcome accounting: every journaled sample below carries
            # prefill_reused plus (on fallback) prefill_fallback, so each
            # answer is attributed to the reuse or the inline path
            reuse_counts = {"reused": 0, "mismatch": 0,
                            "capture_failed": 0, "unsupported": 0}
            prefix_unsupported = False

            for gi, loaded in prefetch_iter(
                list(range(len(groups))), load_group,
                rt.dataloader_num_workers,
            ):
                i, message, meta, inputs = loaded
                t_enc = time.time()
                features = engine.encode_video(
                    inputs["pixel_values_videos"], inputs["video_grid_thw"]
                )
                vision_s = time.time() - t_enc
                grid = inputs["video_grid_thw"]
                # the LLM video prefill is also question-independent when
                # prompt_guided_compression is off: capture it once
                # (engine.VideoPrefix); per-question generate(prefix=...)
                # pays only the trailing text segment + decode and is
                # token-exact or raises PrefixMismatch (then we fall back
                # to the vision-features path)
                prefix = None
                prefix_s = 0.0
                capture_fallback = None
                if prefix_unsupported:
                    capture_fallback = "unsupported"
                else:
                    try:
                        t_pfx = time.time()
                        prefix = engine.encode_prefix(
                            inputs["input_ids"], video_features=features,
                            max_new_tokens=rt.max_new_tokens,
                        )
                        prefix_s = time.time() - t_pfx
                    except PrefixUnsupported as e:
                        # config-level (prompt_guided_compression): no
                        # question-independent prefill exists for any video
                        # under this config; stop attempting captures
                        prefix_unsupported = True
                        capture_fallback = "unsupported"
                        print(f"[rank {rank}] prefix reuse unsupported "
                              f"by config: {e}")
                    except ValueError as e:
                        capture_fallback = "capture_failed"
                        print(f"[rank {rank}] prefix capture failed: {e}")
                for j, midx in enumerate(groups[gi]):
                    if j == 0:
                        sample = (i, message, meta)
                        in_ids = inputs["input_ids"]
                        extras = {"vision_s": round(vision_s, 3),
                                  "prefix_s": round(prefix_s, 3)}
                    else:
                        midx, msg_j, meta_j = dataset.item_light(midx)
                        if grid is not None:
                            in_ids = processor(
                                msg_j["question"], video_grid=grid[0]
                            )["input_ids"]
                        else:
                            in_ids = processor(
                                msg_j["question"], num_frames=features.t
                            )["input_ids"]
                        sample = (midx, msg_j, meta_j)
                        extras = {"vision_s": 0.0, "vision_reused": True}
                    fallback = capture_fallback
                    if prefix is not None:
                        try:
                            dispatch_one(
                                sample,
                                dict(input_ids=in_ids, prefix=prefix),
                                {**extras, "prefill_reused": True},
                            )
                            reuse_counts["reused"] += 1
                            continue
                        except PrefixMismatch as e:
                            fallback = "mismatch"
                            print(f"[rank {rank}] prefix fallback "
                                  f"(idx {sample[0]}): {e}")
                    reuse_counts[fallback or "capture_failed"] += 1
                    dispatch_one(
                        sample,
                        dict(input_ids=in_ids, video_features=features),
                        {**extras, "prefill_reused": False,
                         "prefill_fallback": fallback or "capture_failed"},
                    )
                del features, prefix, loaded, inputs  # free the video's
                #   embeddings + captured KV snapshot
            for bucket in sorted(pending):
                flush_batch(bucket)
            print(f"[rank {rank}] prefix reuse summary: "
                  + ", ".join(f"{k}={v}" for k, v in reuse_counts.items()))
            return done

        for _, loaded in prefetch_iter(
            indices, load, rt.dataloader_num_workers
        ):
            i, message, meta, inputs = loaded
            gen_kwargs = dict(
                input_ids=inputs["input_ids"],
                pixel_values_videos=inputs["pixel_values_videos"],
                video_grid_thw=inputs["video_grid_thw"],
            )
            del inputs, loaded  # big pixel arrays: drop before decode waits
            dispatch_one((i, message, meta), gen_kwargs)
        for bucket in sorted(pending):
            flush_batch(bucket)
    return done


def merge_and_score(rt, world):
    """Merge per-rank shards, score, dump reference-compatible artifacts."""
    from retake_tpu_torch.data.scorers import get_eval_methods

    out_dir = rt.output_dir or "results/eval"
    anno_id2result, anno_id2meta = {}, {}
    for r in range(world):
        with open(os.path.join(out_dir, f"shard_{r:03d}.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                anno_id2result[rec["idx"]] = rec["answer"]
                anno_id2meta[rec["idx"]] = rec["meta"]
    eval_func = get_eval_methods(rt.dataset_name)
    eval_df, infer_df = eval_func(anno_id2result, anno_id2meta)
    with open(os.path.join(out_dir, "anno_id2result.json"), "w") as f:
        json.dump({str(k): v for k, v in anno_id2result.items()}, f)
    infer_df.to_csv(os.path.join(out_dir, "infer_results.csv"), index=False)
    eval_df.to_csv(os.path.join(out_dir, "eval_results.csv"), index=True)
    print(eval_df.head())
    return eval_df, infer_df


def _json_safe(obj):
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def _barrier(args):
    if args.coordinator:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
