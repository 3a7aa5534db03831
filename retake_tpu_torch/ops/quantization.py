"""int8 quantization: weight-only and W8A8 linears, per-key KV blocks
(port of ``retake_tpu/ops/quantization.py``).

All quantizers are symmetric: ``scale = max(amax, 1e-8) / 127`` in fp32,
then ``clip(round(x / scale), -127, 127)`` with round-half-to-even
(``torch.round``, like ``jnp.round``), so the int8 values and scales are
bit-identical to the JAX package's on the same fp32 input.

A quantized linear is ``{'w': int8 [.., in, out], 'scale': f32 [.., out]}``;
an unquantized one is ``{'w': float [.., in, out]}``. Callers dispatch on
the presence of ``'scale'`` (``qlinear``), as the JAX layer code does.

* Weight-only (``quantization: int8``): ``(x @ w.to(x.dtype)) * scale``;
  the per-output-channel scale commutes with the contraction. The int8
  weight is cast to the activation dtype on every call (a transient the
  size of the weight in bf16).
* W8A8 (``quantization: w8a8``, prefill only): per-token int8 activations,
  an int8 x int8 -> int32 product (``torch._int_mm``, exact like XLA's
  int32 accumulator), dequantized by both scales. On CUDA ``_int_mm`` takes
  more than 16 rows and k, n that are multiples of 8, and on the H100 it
  refused row counts that are no multiple of 32 at a small k (64): the rows
  are padded with zero rows to a multiple of 32 (exact; a small video's
  merger can have as few as 4 rows), other widths raise in ``_int_mm``.

These linears are library matrix products, as in the JAX package, where
XLA computes them outside any Pallas kernel.
"""

from __future__ import annotations

import torch

_LINEAR_KEYS = ("q", "k", "v", "o", "gate", "up", "down")
_VIT_BLOCK_KEYS = ("qkv", "proj", "fc1", "fc2")
_INT_MM_ROWS = 32  # CUDA row counts are padded to a multiple of this


def _symmetric(x: torch.Tensor, dim: int, amax=None):
    """(int8 values, fp32 scale with ``dim`` kept) of ``x`` reduced over
    ``dim``; ``amax``: the fp32 absmax over ``dim`` (kept), if the caller
    has it (a row split across ranks)."""
    x32 = x.to(torch.float32)
    # divide by a tensor on x's device: PyTorch's CUDA division by a Python
    # or CPU scalar multiplies by its reciprocal, one ulp off IEEE division
    d127 = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    if amax is None:
        amax = x32.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / d127
    if x32 is x:
        x32 = x32.clone()
    q = x32.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor, axis: int = -2) -> dict:
    """Per-output-channel int8: reduce |w| over the input axis."""
    q, scale = _symmetric(w, axis)
    return {"w": q, "scale": scale.squeeze(axis)}


def quantize_embedding(e: torch.Tensor) -> dict:
    """Per-row (per-token) int8 for the embedding table [V, d]."""
    q, scale = _symmetric(e, -1)
    return {"w": q, "scale": scale[:, 0]}


def quantize_kv_block(block: torch.Tensor):
    """Per-key int8 for KV-cache blocks: [.., S, D] -> (int8 [.., S, D],
    f32 scale [.., S])."""
    q, scale = _symmetric(block, -1)
    return q, scale[..., 0]


def quantize_acts(x: torch.Tensor):
    """Per-row (per-token) int8 activations: (int8, f32 scale [.., 1])."""
    return _symmetric(x, -1)


def _int8_acc(xq, w_q) -> torch.Tensor:
    """The exact int32 product of int8 activations [.., k] and weights [k, n]."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    x2 = xq.reshape(-1, k)
    m = x2.shape[0]
    if x2.is_cuda and m % _INT_MM_ROWS:  # zero rows give zero sums: exact
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, -m % _INT_MM_ROWS))
    return torch._int_mm(x2.contiguous(), w_q)[:m].reshape(*lead, -1)


def int8_matmul_prequant(xq, xs, w_q, w_scale, dtype) -> torch.Tensor:
    """int8 x int8 -> int32 over pre-quantized activations (so q/k/v or
    gate/up share one activation quantization), dequantized to ``dtype``."""
    return (_int8_acc(xq, w_q).to(torch.float32) * xs * w_scale).to(dtype)


def int8_linear(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, tp=None) -> torch.Tensor:
    """W8A8 linear: dynamic per-token quantization of x, int8 product,
    dequantize. The int32 sum is exact; the loss is the 8-bit rounding of x.
    ``tp``: row-parallel under tensor parallelism (``qlinear``): the row's
    absmax is all-reduced with MAX before quantizing and the int32
    accumulators are summed before dequantizing, so the result is the
    unsharded one bit for bit."""
    amax = None
    if tp is not None:
        amax = tp.all_reduce(x.to(torch.float32).abs().amax(dim=-1, keepdim=True), "max")
    xq, xs = _symmetric(x, -1, amax)
    return (_summed(_int8_acc(xq, w_q), tp).to(torch.float32) * xs * w_scale).to(x.dtype)


def qlinear(x: torch.Tensor, p: dict, act_int8: bool = False, tp=None, bias_key: str = "b"):
    """Linear over a ``{'w'[, 'scale'][, bias]}`` dict: a plain product for
    float weights; weight-only dequant for int8 weights; W8A8 with
    ``act_int8`` (int8 weights required).

    ``tp``: a row-parallel linear (o, down) under tensor parallelism
    (``parallel/mesh.py``): ``x`` holds this rank's slice of the input
    features and ``p['w']`` the matching rows; the partial products are
    summed over the group before the replicated scale and bias apply. W8A8
    is bit-identical to one device (``int8_linear``); the weight-only and
    float forms sum rounded partial products, which rounds differently
    from one device."""
    w = p["w"]
    if "scale" in p and act_int8:
        y = int8_linear(x, w, p["scale"], tp)
    elif "scale" in p:
        y = _summed(x @ w.to(x.dtype), tp) * p["scale"].to(x.dtype)
    else:
        y = _summed(x @ w, tp)
    b = p.get(bias_key)
    return y if b is None else y + b


def _summed(y: torch.Tensor, tp) -> torch.Tensor:
    """``y`` summed over the ``tp`` group (as it is without one)."""
    return y if tp is None else tp.all_reduce(y, "sum")


def col_major_int8(tree: dict) -> dict:
    """``tree`` with every int8 linear weight (``{'w': int8, 'scale'}``,
    [.., in, out]) stored column-major: same shape and values, each [in,
    out] slice the transpose of a contiguous [out, in]. With the weight in
    this layout ``torch._int_mm`` ran 5-7x faster on the H100 (an sm80
    ``tn`` int8 kernel at 566-925 TOP/s against a forward-compatible
    ``nn`` WMMA one at 116-125); the weight-only product reads either."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = col_major_int8(v)
        elif k == "w" and "scale" in tree and v.dtype == torch.int8:
            out[k] = v.transpose(-1, -2).contiguous().transpose(-1, -2)
        else:
            out[k] = v
    return out


def quantize_linear_stack(w: torch.Tensor) -> dict:
    """``quantize_weight`` of a stacked [L, in, out] (or plain [in, out])
    weight, one [in, out] slice at a time: the result is the same (the
    reduction is per slice), the fp32 transient is one slice."""
    if w.dim() == 2:
        return quantize_weight(w)
    parts = [quantize_weight(w[i]) for i in range(w.shape[0])]
    return {"w": torch.stack([p["w"] for p in parts]),
            "scale": torch.stack([p["scale"] for p in parts])}


def _quantize_keys(tree: dict, keys) -> dict:
    """Copy ``tree`` with each ``tree[key]`` linear replaced by its int8
    ``{'w', 'scale'}`` form (biases and other leaves kept)."""
    out = dict(tree)
    for key in keys:
        out[key] = {**out[key], **quantize_linear_stack(out[key]["w"])}
    return out


def quantize_llm_int8(params: dict) -> dict:
    """Quantize the decoder linears, the LM head and the embedding of a
    parameter tree; norms, biases and the vision tower stay as they are."""
    out = dict(params)
    out["layers"] = _quantize_keys(params["layers"], _LINEAR_KEYS)
    out["embed_tokens"] = quantize_embedding(params["embed_tokens"])
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"])
    return out


def quantize_vit_int8(visual: dict) -> dict:
    """Quantize the vision tower's block and merger linears (W8A8 mode);
    the patch embed, norms and biases stay as they are."""
    out = dict(visual)
    out["blocks"] = _quantize_keys(visual["blocks"], _VIT_BLOCK_KEYS)
    out["merger"] = _quantize_keys(visual["merger"], ("fc1", "fc2"))
    return out


def quantize_siglip_int8(params: dict) -> dict:
    """Quantize the LLaVA SigLIP block linears and the multimodal projector
    (W8A8 mode); the patch and position embeddings and the norms stay as
    they are."""
    out = dict(params)
    tower = dict(params["vision_tower"])
    tower["blocks"] = _quantize_keys(tower["blocks"], ("q", "k", "v", "out", "fc1", "fc2"))
    out["vision_tower"] = tower
    out["projector"] = _quantize_keys(params["projector"], ("linear_1", "linear_2"))
    return out
