"""The system under test: the PyTorch / CUDA port (``retake_tpu_torch``).
This is the only module of the benchmark that imports it. It builds an
engine from the benchmark's configuration and parameter tree, runs
requests through the engine's own entry points (``generate``,
``ContinuousServer.run``), and, in a traced run, records the shapes of each
call into the port's hand-written kernels.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List

import torch


def retake_config(config: dict, control: bool = False):
    """The engine's ``RetakeConfig`` from the configuration's ``retake``
    dict; ``control``: the program's own lower-precision path switched on
    (W8A8 linears, an int8 KV cache)."""
    from retake_tpu_torch.utils.config import RetakeConfig

    d = dict(config["retake"])
    if control:
        d.update(quantization="w8a8", kv_cache_dtype="int8")
    return RetakeConfig.from_dict(d)


def build(family: str, config: dict, tree: dict, device, control: bool = False):
    """An engine over ``tree`` (shared, not copied; ``control`` quantizes a
    copy of its linears to int8)."""
    from retake_tpu_torch.ops import quantization as q8

    rt = retake_config(config, control)
    params = tree
    if family == "qwen2_vl":
        from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig
        from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
        from retake_tpu_torch.runtime.engine import Qwen2VLEngine

        cfg = Qwen2VLConfig.from_hf_dict(config)
        if control:
            params = q8.quantize_llm_int8(tree)
            params["visual"] = q8.quantize_vit_int8(tree["visual"])
        return Qwen2VLEngine(cfg, Qwen2VLModel(cfg, params), rt, device=device)
    if family == "llava_video":
        from retake_tpu_torch.models.llava_onevision.config import LlavaOnevisionConfig
        from retake_tpu_torch.models.llava_onevision.model import LlavaOnevisionModel
        from retake_tpu_torch.runtime.llava_engine import LlavaOnevisionEngine

        cfg = LlavaOnevisionConfig.from_hf_dict(config)
        if control:
            params = q8.quantize_siglip_int8(q8.quantize_llm_int8(tree))
        return LlavaOnevisionEngine(cfg, LlavaOnevisionModel(cfg, params), rt, device=device)
    raise ValueError(f"unknown model family {family!r}")


def generate_kwargs(req: dict) -> dict:
    """A request's inputs as ``generate`` keyword arguments."""
    if "patches" in req:
        return dict(input_ids=req["ids"], pixel_values_videos=req["patches"],
                    video_grid_thw=req["grid"])
    return dict(input_ids=req["ids"], pixel_values_videos=req["video"])


def generate(engine, req: dict, max_new_tokens: int):
    return engine.generate(**generate_kwargs(req), max_new_tokens=max_new_tokens)


def server(engine, settings: dict):
    from retake_tpu_torch.runtime.serve import ContinuousServer

    return ContinuousServer(engine, **settings)


# ---------- kernel calls (traced runs) ----------


def _scalar(x):
    """A device scalar copied now (the cache length advances in place)."""
    return x.detach().reshape(-1)[:1].clone() if isinstance(x, torch.Tensor) else int(x)


def _int(x) -> int:
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


class KernelCalls:
    """Wraps the port's kernel entry points and records each call's shapes
    (device scalars copied on the device, read once the stretch is over).
    It depends on the names in ``recording`` and, for the device time, on
    the kernel names in ``KERNEL_NAMES``: an entry point that is gone is
    not wrapped, and its roofline reads nothing."""

    def __init__(self):
        self.raw: Dict[str, List[dict]] = {"k1": [], "k2": [], "k3": [], "k4": []}

    @contextlib.contextmanager
    def recording(self):
        from retake_tpu_torch.ops.cuda import (decode_gapped, flash_prefill, pivot_scores,
                                                vit_attention)

        wrapped = [
            (flash_prefill, "flash_prefill_attention", self._k1),
            (pivot_scores, "pivot_score_sums", self._k2),
            (vit_attention, "vit_attention_qkv", self._k3),
            (decode_gapped, "decode_gapped_flash_state", self._k4),
        ]
        saved = []
        for mod, name, rec in wrapped:
            fn = getattr(mod, name, None)
            if fn is None:  # gone from the program: its roofline reads nothing
                continue
            saved.append((mod, name, fn))

            @functools.wraps(fn)  # keeps the attributes the wrapped function updates
            def call(*args, _fn=fn, _rec=rec, **kw):
                _rec(*args, **kw)
                return _fn(*args, **kw)

            setattr(mod, name, call)
        try:
            yield self
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    def _k1(self, q, kc, vc, cache_len, kn, vn, valid_len, k_scale=None, *a, **kw):
        self.raw["k1"].append(dict(heads=q.shape[0], kv=kc.shape[0], d=q.shape[2],
                                   cache_len=_scalar(cache_len), valid=_scalar(valid_len),
                                   int8_kv=k_scale is not None))

    def _k2(self, q, k, valid_len):
        self.raw["k2"].append(dict(heads=q.shape[0], kv=k.shape[0], d=q.shape[2],
                                   valid=_scalar(valid_len)))

    def _k3(self, qkv, cos, sin):
        t, s, n, _, d = qkv.shape
        self.raw["k3"].append(dict(t=t, s=s, n=n, d=d))

    def _k4(self, q, kc, vc, final_len, dec_start, write_end, k_scale=None, v_scale=None):
        self.raw["k4"].append(dict(kv=q.shape[1], group=q.shape[2], d=q.shape[3],
                                   final_len=final_len.detach().clone(),
                                   dec_start=dec_start.detach().clone(),
                                   write_end=_int(write_end), int8_kv=k_scale is not None))

    def resolved(self) -> Dict[str, List[dict]]:
        """Every call with its device scalars read back as ints."""
        out = {}
        for k, calls in self.raw.items():
            res = []
            for c in calls:
                c = dict(c)
                for key in ("cache_len", "valid"):
                    if key in c:
                        c[key] = _int(c[key])
                for key in ("final_len", "dec_start"):
                    if key in c:
                        c[key] = [int(x) for x in c[key].tolist()]
                res.append(c)
            out[k] = res
        return out


KERNEL_NAMES = {  # device kernel names (profiler) of each port kernel
    "k1": ("flash_prefill_kernel",),
    "k2": ("row_stats_kernel", "col_sums_kernel", "::merge_kernel"),
    "k3": ("vit_attention_kernel",),
    "k4": ("decode_gapped_kernel",),
}


# ---------- the logits the timed path produces (for the check) ----------


class LogitTap:
    """Copies, on the device, the logits the engine itself computes for the
    tokens it serves: the first token's (``text.final_logits`` at the end
    of a prefill) and each decode step's (``final_logits`` in the
    sequential loop; the served slots' rows of ``final_logits_batch`` in the
    server's batched segments). ``rows[key]`` maps a request's token index
    (0: the first token) to its logits.

    Closed loop: ``key`` is set by the caller around each request, and
    ``first_at[key]`` is the harness's clock when the request's first
    logits are on the device (a synchronize, as the engine makes there to
    read the token). Server: ``watch`` names the request indices to keep and
    ``index_of`` maps a request's ``input_ids`` object to its index; the slot
    a request holds and its step count come from the server's own state at
    each segment.

    The program's names this depends on (a change that renames or bypasses
    one keeps an equivalent, or the runs read not correct):
    ``models.qwen2_vl.text.final_logits`` and ``final_logits_batch`` looked up
    on the module at each call, ``runtime.serve._decode_loop_batch``, the
    server's ``_slot_req`` and ``emitted`` during a segment, and the server's
    prefill calling ``engine.generate(input_ids=...)``. A name that is gone
    is left unpatched: its rows stay missing and the check reads them so."""

    def __init__(self, watch=None, index_of=None):
        self.rows = {}
        self.key = None
        self.first_at = {}
        self.watch = set(watch or ())
        self.index_of = index_of or {}
        self._seg = None  # (slot -> request index, slot -> steps emitted, step)

    def _keep(self, key, pos: int, logits):
        self.rows.setdefault(key, {})[pos] = logits.detach().clone()

    @contextlib.contextmanager
    def tapping(self, srv=None):
        from retake_tpu_torch.models.qwen2_vl import text
        from retake_tpu_torch.runtime import serve

        final = getattr(text, "final_logits", None)
        batch = getattr(text, "final_logits_batch", None)
        loop = getattr(serve, "_decode_loop_batch", None)
        engine = srv.engine if srv is not None else None

        def final_logits(*args, **kw):
            out = final(*args, **kw)
            if self.key is not None and srv is None and self.key not in self.first_at:
                if out.is_cuda:
                    torch.cuda.synchronize(out.device)
                self.first_at[self.key] = time.perf_counter()
            if self.key is not None and (srv is None or self.key in self.watch):
                self._keep(self.key, len(self.rows.get(self.key, {})), out)
            return out

        def final_logits_batch(*args, **kw):
            out = batch(*args, **kw)
            if self._seg is not None:
                slots, emitted, step = self._seg
                for slot, rid in slots.items():
                    if rid in self.watch:
                        self._keep(rid, int(emitted[slot]) + step + 1, out[slot])
                self._seg = (slots, emitted, step + 1)
            return out

        def decode_loop_batch(*args, **kw):
            slots = dict(getattr(srv, "_slot_req", None) or {})
            emitted = getattr(srv, "emitted", None)
            self._seg = (slots, emitted.copy(), 0) if emitted is not None else None
            try:
                return loop(*args, **kw)
            finally:
                self._seg = None

        def generate_keyed(*args, _generate=engine.generate if engine is not None else None,
                           **kw):
            self.key = self.index_of.get(id(kw.get("input_ids", args[0] if args else None)))
            try:
                return _generate(*args, **kw)
            finally:
                self.key = None

        patched = [(text, "final_logits", final, final_logits)]
        if srv is not None:
            patched += [(text, "final_logits_batch", batch, final_logits_batch),
                        (serve, "_decode_loop_batch", loop, decode_loop_batch)]
            engine.generate = generate_keyed
        patched = [p for p in patched if p[2] is not None]
        for mod, name, _, fn in patched:
            setattr(mod, name, fn)
        try:
            yield self
        finally:
            for mod, name, orig, _ in patched:
                setattr(mod, name, orig)
            if srv is not None:
                del engine.generate  # the instance attribute: back to the method

    def stacked(self, key, n: int):
        """[n, V] f32 host rows 0..n-1 of request ``key`` (None where a row
        was not seen)."""
        got = self.rows.get(key, {})
        if any(i not in got for i in range(n)):
            return None
        return torch.stack([got[i].float().reshape(-1) for i in range(n)]).cpu()

    def to_host(self, key):
        """Move a finished request's rows off the device."""
        if key in self.rows:
            self.rows[key] = {i: r.float().cpu() for i, r in self.rows[key].items()}
