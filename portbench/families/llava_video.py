"""LLaVA-Video: SigLIP so400m, the projector and 2x2 pooling before a Qwen2
decoder with 1-D RoPE. A request's video is uint8 ``video`` frames at the
tower's image size.

The family's parameter tree, engine, request layout and inputs, plain
reference and floating-point work, found by ``spec.family`` from the
configuration's ``family`` key.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import counts, program, traffic as traffic_lib, weights
from portbench.reference import models as ref_models, text as plan_lib


def tree(config: dict, seed: int, device) -> dict:
    """The decoder, SigLIP (patch embed with bias, learned position
    embedding, blocks), the projector and ``image_newline``."""
    draw = weights.Draw(seed, device)
    v, tc = config["vision_config"], config["text_config"]
    d, m, l = v["hidden_size"], v["intermediate_size"], v["num_hidden_layers"]
    g = v["image_size"] // v["patch_size"]
    pdim = 3 * v["patch_size"] ** 2
    td = tc["hidden_size"]
    out = weights.text_tree(draw, tc)
    out["vision_tower"] = {
        "patch_embed": draw.linear(pdim, d),
        "pos_embed": draw.normal((g * g, d), 0.02),
        "blocks": {
            "ln1": draw.layer_norm(l, d),
            **{k: draw.linear(l, d, d) for k in ("q", "k", "v", "out")},
            "ln2": draw.layer_norm(l, d),
            "fc1": draw.linear(l, d, m),
            "fc2": draw.linear(l, m, d),
        },
    }
    out["projector"] = {"linear_1": draw.linear(d, td), "linear_2": draw.linear(td, td)}
    out["image_newline"] = draw.normal((td,), 0.02)
    return out


def build(config: dict, tree: dict, device, control: bool = False):
    """The port's ``LlavaOnevisionEngine`` over ``tree`` (shared, not
    copied; ``control`` quantizes a copy of its linears to int8)."""
    from retake_tpu_torch.models.llava_onevision.config import LlavaOnevisionConfig
    from retake_tpu_torch.models.llava_onevision.model import LlavaOnevisionModel
    from retake_tpu_torch.ops import quantization as q8
    from retake_tpu_torch.runtime.llava_engine import LlavaOnevisionEngine

    rt = program.retake_config(config, control)
    cfg = LlavaOnevisionConfig.from_hf_dict(config)
    params = q8.quantize_siglip_int8(q8.quantize_llm_int8(tree)) if control else tree
    return LlavaOnevisionEngine(cfg, LlavaOnevisionModel(cfg, params), rt, device=device)


def _per_frame(config: dict) -> int:
    v = config["vision_config"]
    g = v["image_size"] // v["patch_size"]
    return (-(-g // config.get("pool_stride", 2))) ** 2


def layout(config: dict, traffic: dict, frames: int, pre=None, post=None):
    """(ids, None, tokens per prefill chunk) of a request of ``frames``
    frames (``traffic.layout``)."""
    pre, post = traffic_lib.text_or_zeros(traffic, pre, post)
    cf = traffic_lib.chunk_frames(config)
    per_frame = _per_frame(config)
    ids = np.concatenate([pre, np.full(frames * per_frame + 1, config["video_token_index"]),
                          post]).astype(np.int64)
    chunk = None if cf is None else min(cf, frames) * per_frame
    return ids, None, chunk


def request(config: dict, traffic: dict, seed: int, index: int, frames: int, device) -> dict:
    """Request ``index``'s ``ids`` (numpy) and uint8 ``video`` frames
    (``traffic.request``)."""
    pre, post = traffic_lib.text_ids(traffic, seed, index)
    ids, _, _ = layout(config, traffic, frames, pre, post)
    gen = traffic_lib.pixel_generator(seed, index, device)
    size = config["vision_config"]["image_size"]
    video = torch.randint(0, 256, (frames, size, size, 3), generator=gen, device=device,
                          dtype=torch.int32).to(torch.uint8)
    return dict(ids=ids, video=video, frames=frames)


def reference_logits(tree: dict, config: dict, req: dict, streams: list, device) -> list:
    """For each stream of served tokens, the plain reference's logits at
    its positions."""
    return ref_models.llava_video_logits(tree, config, req["ids"], req["video"], streams, device)


def request_flops(config: dict, traffic: dict, frames: int, decode_tokens: int = 0) -> float:
    """SigLIP with the projector, the text prefill of the request's plan
    and ``decode_tokens`` decode steps."""
    ids, _, chunk = layout(config, traffic, frames)
    text = config["text_config"]
    vision = counts.siglip_flops(config["vision_config"], text["hidden_size"], frames)
    steps = plan_lib.plan(ids, config["video_token_index"], chunk,
                          plan_lib.compression_ratio(config["retake"], len(ids)))
    return counts.request_flops(vision, text, steps, decode_tokens)
