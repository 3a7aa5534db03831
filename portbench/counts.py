"""The yardstick's arithmetic: the chip's peaks, each kernel's operations and
bytes for the shapes of one call, and the floating-point work a request's
algorithm needs (for the whole-step ``*_mfu`` shares).

Counts follow one rule for every kernel: each input byte read once and
each output byte written once, whatever the kernel reads again; only the
rows and columns the inputs make valid count (padding rows do not). A
multiply-add is two operations. Exponentials and normalisations are not
counted.
"""

from __future__ import annotations

from typing import Dict, List

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

BF16, F32, I8 = 2, 4, 1


def bound_seconds(count: Dict[str, float]) -> float:
    """The least time the chip could take for a call's ``{"flops",
    "bytes"}``: the larger of the compute and the memory bound."""
    return max(count["flops"] / PEAK_BF16_FLOPS, count["bytes"] / PEAK_HBM_BYTES)


# ---------- kernels (per call) ----------


def k1_prefill(heads: int, kv: int, d: int, cache_len: int, valid: int,
               int8_kv: bool = False) -> Dict[str, float]:
    """Chunk-prefill attention over [cache | causal chunk]: valid rows only.
    Row i attends to ``cache_len + i + 1`` keys."""
    keys = valid * cache_len + valid * (valid + 1) / 2
    flops = 4.0 * heads * d * keys
    kv_col = (d * I8 + F32) if int8_kv else d * BF16  # one K (or V) column and its scale
    nbytes = 2 * heads * valid * d * BF16 + 2 * kv * (cache_len + valid) * kv_col
    return {"flops": flops, "bytes": nbytes}


def k2_scores(heads: int, kv: int, d: int, valid: int) -> Dict[str, float]:
    """PivotKV column sums of softmax(q kᵀ) over the chunk's valid rows:
    one q kᵀ product per head; the [KV, S] f32 sums written once."""
    flops = 2.0 * heads * valid * valid * d
    nbytes = (heads + kv) * valid * d * BF16 + kv * valid * F32
    return {"flops": flops, "bytes": nbytes}


def k3_vit(t: int, s: int, n: int, d: int) -> Dict[str, float]:
    """ViT attention within each of ``t`` slices of ``s`` patches, rotary
    fused: qkv read, the f32 cos/sin tables read, the output written."""
    flops = 4.0 * t * n * s * s * d
    nbytes = t * s * n * 3 * d * BF16 + 2 * s * d * F32 + t * s * n * d * BF16
    return {"flops": flops, "bytes": nbytes}


def k4_live_columns(final_len: List[int], dec_start: List[int], write_end: int) -> List[int]:
    """Live columns per slot of the gap-layout cache: the prefill
    ``[0, final_len)`` and the slot's decode region ``[dec_start, write_end)``."""
    return [fl + max(0, write_end - max(ds, fl)) for fl, ds in zip(final_len, dec_start)]


def k4_decode(kv: int, group: int, d: int, live: List[int],
              int8_kv: bool = False) -> Dict[str, float]:
    """Batched decode state over each slot's live columns: K and V of every
    live column read once, the queries read, (acc f32, m, l) written."""
    b = len(live)
    cols = sum(live)
    flops = 4.0 * kv * group * d * cols
    kv_col = (d * I8 + F32) if int8_kv else d * BF16
    nbytes = 2 * kv * cols * kv_col + b * kv * group * d * BF16 + b * kv * group * (d + 2) * F32
    return {"flops": flops, "bytes": nbytes}


# ---------- whole requests ----------


def head_dim(c: dict) -> int:
    """The text config's ``head_dim`` where it gives one, else
    ``hidden_size // num_attention_heads``."""
    return c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"]


def text_linear_flops(c: dict, tokens: int) -> float:
    """q/k/v/o and the SwiGLU MLP over ``tokens`` rows, every layer."""
    d, m, l = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"]
    hd = head_dim(c)
    qd = c["num_attention_heads"] * hd
    kvd = c["num_key_value_heads"] * hd
    per_layer = d * qd + 2 * d * kvd + qd * d + 3 * d * m
    return 2.0 * tokens * per_layer * l


def lm_head_flops(c: dict, rows: int) -> float:
    return 2.0 * rows * c["hidden_size"] * c["vocab_size"]


def attention_flops(c: dict, cache_len: int, valid: int) -> float:
    """[cache | causal chunk] attention over all layers."""
    hd = head_dim(c)
    keys = valid * cache_len + valid * (valid + 1) / 2
    return 4.0 * c["num_attention_heads"] * hd * keys * c["num_hidden_layers"]


def score_flops(c: dict, valid: int) -> float:
    hd = head_dim(c)
    return 2.0 * c["num_attention_heads"] * valid * valid * hd * c["num_hidden_layers"]


def qwen_vit_flops(v: dict, grid_t: int, gh: int, gw: int) -> float:
    """Qwen2-VL ViT over ``grid_t`` slices of ``gh * gw`` patches: patch
    embed, blocks (attention within each slice), 2x2 merger."""
    e, depth = v["embed_dim"], v["depth"]
    mlp = e * v["mlp_ratio"]
    s = gh * gw
    n = grid_t * s
    pdim = v.get("in_chans", 3) * v["temporal_patch_size"] * v["patch_size"] ** 2
    m2 = v["spatial_merge_size"] ** 2
    lin = 2.0 * n * (pdim * e + depth * (3 * e * e + e * e + 2 * e * mlp))
    att = 4.0 * grid_t * s * s * e * depth  # heads x head_dim = e
    merger = 2.0 * (n / m2) * (m2 * e * m2 * e + m2 * e * v["hidden_size"])
    return lin + att + merger


def siglip_flops(v: dict, text_hidden: int, frames: int) -> float:
    """SigLIP over ``frames`` frames of ``grid²`` patches, then the
    projector on every patch (the pooling is not counted)."""
    d, m, layers = v["hidden_size"], v["intermediate_size"], v["num_hidden_layers"]
    g = v["image_size"] // v["patch_size"]
    s = g * g
    pdim = 3 * v["patch_size"] ** 2
    n = frames * s
    lin = 2.0 * n * (pdim * d + layers * (4 * d * d + 2 * d * m))
    att = 4.0 * frames * s * s * d * layers
    proj = 2.0 * n * (d * text_hidden + text_hidden * text_hidden)
    return lin + att + proj


def prefill_flops(c: dict, steps: List[dict]) -> float:
    """The text prefill of a plan (``reference.text.plan``): linears over
    the valid rows, attention over the [cache | chunk] each step visited,
    the PivotKV scores of each compressing step, the first token's head."""
    total = 0.0
    for st in steps:
        total += text_linear_flops(c, st["valid"])
        total += attention_flops(c, st["cache_len"], st["valid"])
        if st["compress"]:
            total += score_flops(c, st["valid"])
    return total + lm_head_flops(c, 1)


def decode_flops(c: dict, context: int, tokens: int) -> float:
    """``tokens`` decode steps over a cache of ``context`` entries that
    grows by one a step."""
    total = 0.0
    for i in range(tokens):
        total += text_linear_flops(c, 1) + attention_flops(c, context + i, 1)
    return total + lm_head_flops(c, tokens)


def request_flops(vision: float, c: dict, steps: List[dict], decode_tokens: int = 0) -> float:
    """A request's work: ``vision`` (the family's tower), the text prefill
    of its plan and ``decode_tokens`` decode steps over what the plan kept."""
    total = vision + prefill_flops(c, steps)
    if decode_tokens:
        total += decode_flops(c, sum(s["keep"] for s in steps), decode_tokens)
    return total
