"""Qwen2-VL: the ViT (2-D rotary, 2x2 patch merger) before a Qwen2 decoder
with M-RoPE. A request's video is ``patches`` of ``frame_hw`` frames
(448x252: a 32 x 18 grid) with its ``grid`` [t, h, w].

The family's parameter tree, engine, request layout and inputs, plain
reference and floating-point work, found by ``spec.family`` from the
configuration's ``family`` key.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import counts, program, traffic as traffic_lib, weights
from portbench.reference import models as ref_models, text as plan_lib


def tree(config: dict, seed: int, device) -> dict:
    """The decoder and the ViT (patch embed without bias, blocks, 2x2
    merger)."""
    draw = weights.Draw(seed, device)
    v = config["vision_config"]
    e, depth, mlp = v["embed_dim"], v["depth"], v["embed_dim"] * v["mlp_ratio"]
    pdim = v.get("in_chans", 3) * v["temporal_patch_size"] * v["patch_size"] ** 2
    merged = e * v["spatial_merge_size"] ** 2
    visual = {
        "patch_embed": {"w": draw.normal((pdim, e), 1.0 / math.sqrt(pdim))},
        "blocks": {
            "ln1": draw.layer_norm(depth, e),
            "qkv": draw.linear(depth, e, 3 * e),
            "proj": draw.linear(depth, e, e),
            "ln2": draw.layer_norm(depth, e),
            "fc1": draw.linear(depth, e, mlp),
            "fc2": draw.linear(depth, mlp, e),
        },
        "merger": {
            "ln_q": draw.layer_norm(e),
            "fc1": draw.linear(merged, merged),
            "fc2": draw.linear(merged, v["hidden_size"]),
        },
    }
    out = weights.text_tree(draw, config)
    out["visual"] = visual
    return out


def build(config: dict, tree: dict, device, control: bool = False):
    """The port's ``Qwen2VLEngine`` over ``tree`` (shared, not copied;
    ``control`` quantizes a copy of its linears to int8)."""
    from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig
    from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
    from retake_tpu_torch.ops import quantization as q8
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine

    rt = program.retake_config(config, control)
    cfg = Qwen2VLConfig.from_hf_dict(config)
    params = tree
    if control:
        params = q8.quantize_llm_int8(tree)
        params["visual"] = q8.quantize_vit_int8(tree["visual"])
    return Qwen2VLEngine(cfg, Qwen2VLModel(cfg, params), rt, device=device)


def layout(config: dict, traffic: dict, frames: int, pre=None, post=None):
    """(ids, grid, tokens per prefill chunk) of a request of ``frames``
    frames (``traffic.layout``)."""
    pre, post = traffic_lib.text_or_zeros(traffic, pre, post)
    cf = traffic_lib.chunk_frames(config)
    v = config["vision_config"]
    tps, ps, m = v["temporal_patch_size"], v["patch_size"], v["spatial_merge_size"]
    h, w = (x // ps for x in traffic["frame_hw"])
    t = frames // tps
    ids = np.concatenate([pre, [config["vision_start_token_id"]],
                          np.full(t * h * w // m**2, config["video_token_id"]),
                          [config["vision_end_token_id"]], post]).astype(np.int64)
    chunk = None if cf is None else min(cf, frames) * h * w // (m * m * tps)
    return ids, np.array([[t, h, w]]), chunk


def request(config: dict, traffic: dict, seed: int, index: int, frames: int, device) -> dict:
    """Request ``index``'s ``ids`` (numpy), bf16 ``patches`` and ``grid``
    (``traffic.request``)."""
    pre, post = traffic_lib.text_ids(traffic, seed, index)
    ids, grid, _ = layout(config, traffic, frames, pre, post)
    gen = traffic_lib.pixel_generator(seed, index, device)
    v = config["vision_config"]
    t, h, w = (int(x) for x in grid[0])
    dim = v.get("in_chans", 3) * v["temporal_patch_size"] * v["patch_size"] ** 2
    raw = torch.randint(0, 255, (t * h * w, dim), generator=gen, device=device, dtype=torch.int32)
    patches = ((raw.to(torch.float32) - 127.5) / 64.0).to(torch.bfloat16)
    return dict(ids=ids, patches=patches, grid=grid, frames=frames)


def reference_logits(tree: dict, config: dict, req: dict, streams: list, device) -> list:
    """For each stream of served tokens, the plain reference's logits at
    its positions."""
    return ref_models.qwen2_vl_logits(tree, config, req["ids"], req["patches"], req["grid"][0],
                                      streams, device)


def request_flops(config: dict, traffic: dict, frames: int, decode_tokens: int = 0) -> float:
    """The ViT, the text prefill of the request's plan and
    ``decode_tokens`` decode steps."""
    ids, grid, chunk = layout(config, traffic, frames)
    t, h, w = (int(x) for x in grid[0])
    vision = counts.qwen_vit_flops(config["vision_config"], t, h, w)
    steps = plan_lib.plan(ids, config["video_token_id"], chunk,
                          plan_lib.compression_ratio(config["retake"], len(ids)))
    return counts.request_flops(vision, config, steps, decode_tokens)
