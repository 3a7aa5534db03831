"""The system under test: the PyTorch / CUDA port (``retake_tpu_torch``).
It runs requests through the engine's own entry points (``generate``,
``ContinuousServer.run``), taps the logits they compute, and, in a traced
run, records the shapes of each call into the port's hand-written kernels
(``portbench/kernels/<k>.py`` name each entry point). The engine itself is
built by the model family's ``build`` (``portbench/families/<family>.py``).
This module, the families' ``build`` and the kernel entry points wrapped
here are all that import the port, and only inside functions; the
reference (``portbench/reference``) imports nothing of it.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
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


def device_scalar(x):
    """A device scalar copied now, on the device (the cache length advances
    in place)."""
    return x.detach().reshape(-1)[0].clone() if isinstance(x, torch.Tensor) else int(x)


def host_int(x) -> int:
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


def _host(v):
    """A recorded value read back: a device scalar as an int, a device
    vector as a list of ints."""
    if not isinstance(v, torch.Tensor):
        return v
    return host_int(v) if v.dim() == 0 else [int(x) for x in v.tolist()]


class KernelCalls:
    """Wraps the entry point of each kernel module (``portbench/kernels/<k>.py``:
    ``ENTRY``, ``record``) and records each call's shapes, device scalars
    copied on the device and read once the stretch is over (``resolved``).
    An entry point that is gone is not wrapped, and its roofline reads
    nothing."""

    def __init__(self, kernels: Dict[str, object]):
        self.kernels = kernels  # name -> kernel module (spec.kernels)
        self.raw: Dict[str, List[dict]] = {k: [] for k in kernels}

    @contextlib.contextmanager
    def recording(self):
        saved = []
        for k, kmod in self.kernels.items():
            path, name = kmod.ENTRY
            try:
                mod = importlib.import_module(path)
            except ModuleNotFoundError:  # gone from the program: its roofline reads nothing
                continue
            fn = getattr(mod, name, None)
            if fn is None:
                continue
            saved.append((mod, name, fn))

            @functools.wraps(fn)  # keeps the attributes the wrapped function updates
            def call(*args, _fn=fn, _calls=self.raw[k], _rec=kmod.record, **kw):
                _calls.append(_rec(*args, **kw))
                return _fn(*args, **kw)

            setattr(mod, name, call)
        try:
            yield self
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    def resolved(self) -> Dict[str, List[dict]]:
        """Every call with its device scalars read back."""
        return {k: [{key: _host(v) for key, v in c.items()} for c in calls]
                for k, calls in self.raw.items()}


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
