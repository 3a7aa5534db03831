"""Continuous batching: admit new requests mid-decode
(port of ``retake_tpu/runtime/serve.py``: greedy or sampled; bf16 or int8
KV cache).

Decode runs in fixed-size SEGMENTS of ``segment_steps`` steps; between
segments the host admits newly arrived requests into free batch slots and
harvests finished ones.

* Writes stay batch-uniform. Every live slot's step token lands at column
  ``gap_start + F`` (F = global step counter, a host int), so the per-step
  append is one strided copy at a host-known offset. A slot admitted at
  F = t0 owns decode columns [gap_start + t0, ...); older columns belong to
  previous tenants and are masked per slot through ``dec_start``
  (ops/attention.decode_attention_batch_gapped).
* Positions continue analytically: the loop computes temporal row
  ``base_t + F``; admission stores ``base_t_own - t0`` and compaction
  (F -> 0) adds the consumed F back. Same for the M-RoPE rows (pos_rest).
* Shapes never change: the cache is [L, B, KV, P + G, D] for the server's
  lifetime (P = prefill bucket, G = gap columns), allocated once with
  ``torch.zeros`` and updated in place.
* When the gap region would overflow (F + segment > gap capacity), each
  live slot's decoded K/V, contiguous at [dec_start_b, gap_start + F), is
  folded onto its prefill tail [final_len_b, final_len_b + c_b) by one
  gather per layer (``_compact_gap``), final_len grows, dec_start resets,
  F -> 0. It always fits: admission guarantees final_len + max_new <= P.
* int8 KV cache (``kv_cache_dtype: int8``): k/v are int8 and the per-key
  scales live in planes ``ks_all`` / ``vs_all`` [L, B, KV, P + G] f32 next
  to them; admission inserts them, every step writes them, compaction moves
  them with k/v. The TPU kernel's tile rules for them (the int8 bump of the
  gap columns, the row-aligned block choice) are not carried over.

All device work is issued on one CUDA stream in program order, so a
segment enqueued after a compaction reads the folded cache; the JAX
module's host fence after the fold (a CPU-backend buffer-donation race)
has no counterpart here.

``decode_attn_impl="auto"`` takes K4 (``"pallas"``) when the engine runs on
CUDA and the model's GQA group fits the kernel, the plain arm (``"xla"``)
otherwise; ``"flash"`` takes K4 as ``"pallas"`` does.

Sampling (``do_sample``) is reproducible: each slot draws at its
request-own step (the global step minus ``step_off``, which admission sets
and compaction rebases with F), so a sampled request gets the noise of its
sequential ``generate`` whatever its arrival, slot or compactions.

Caches across questions about one video: a request may carry a
``video_key``. With ``vision_cache_slots`` the server keeps an LRU of
``engine.encode_video`` features under it (a hit skips the ViT and visual
compression), with ``prefix_cache_slots`` an LRU of ``engine.encode_prefix``
captures (a hit also skips the video prefill; ``PrefixMismatch`` falls back
to the inline prefill, ``PrefixBudgetOverflow`` recaptures). The caches are
dicts that only the serving loop's thread mutates, and only by single dict
operations (pop, reinsert, insert, evict), so another thread may peek them
with one ``get`` (``runtime/http_server.py`` does).

Online mode (``start_online`` -> ``OnlineHandle``): one worker thread runs
the serving loop and does all device work; callers ``submit`` from any
thread and get a ``concurrent.futures.Future``. Grad mode and the current
CUDA stream are per thread in PyTorch: the worker runs under
``torch.no_grad`` on its own current stream, the device's default one, and
every device operation of the server is issued there in program order.

Tensor parallelism (an engine built with ``tp=``): every rank runs ``run``
(or ``start_online``) and the gap-layout cache holds the rank's KV heads.
The loop decides by the wall clock (arrivals, deadlines) and by the
``on_tokens`` verdicts, which two processes would read differently and then
hang in a collective. So rank 0 alone reads the clock and calls
``on_tokens``, and broadcasts each decision (which request arrives, whether
one is cancelled) as a few ints; the other ranks act on the broadcast.
``run`` sends a request's index (every rank holds the list); online, rank 0
sends the request itself (``_send_request``): its fields as a JSON header
and its arrays as tensors, except features it carries under a
``video_key`` that is still in a cache at admission, which every rank then
takes from its own cache. The ranks run the same admissions in the same
order, so their caches (hits, evictions, captures, ``PrefixMismatch``
fallbacks, recaptures) stay in lockstep; under ``tp.check`` they compare
their cache keys and ``stats`` after each admission. An admission that
raises on every rank before any collective (a malformed request) fails its
request alone; any other error ends the worker on every rank (the others'
next collective times out or fails). Rank 0's idle worker still broadcasts
a "wait" at least every ``IDLE_POLL_S``, so the other ranks' collectives
never sit out the group's timeout.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from retake_tpu_torch.parallel.mesh import BROADCAST_DTYPES
from retake_tpu_torch.runtime.engine import (
    PrefillState,
    PrefixBudgetOverflow,
    PrefixMismatch,
    PrefixUnsupported,
    VideoFeatures,
    _decode_loop_batch,
    _insert_batch_slot,
    batched_decode_impl,
)
from retake_tpu_torch.runtime.sampling import Sampler
from retake_tpu_torch.utils.profiling import span

GAP_ALIGN = 2048  # the shared bucket (prefill bucket + gap) is a multiple of this
_EVENTS = ("end", "wait", "req")  # the source's events, by their code under TP
IDLE_POLL_S = 1.0  # an idle online worker's longest wait before the next event


def _pack(v, tensors: list):
    """A JSON-able description of one request value; its arrays and tensors
    are appended to ``tensors`` (sent after the description)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return {"v": v}
    if isinstance(v, np.generic):
        return {"v": v.item()}
    if isinstance(v, (np.ndarray, torch.Tensor)):
        t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        if t.dtype not in BROADCAST_DTYPES:
            raise TypeError(f"a request array of dtype {t.dtype} cannot travel between ranks")
        tensors.append(t)
        return {"np" if isinstance(v, np.ndarray) else "torch": len(tensors) - 1,
                "cuda": t.is_cuda}
    if isinstance(v, (list, tuple)):
        return {"seq": [_pack(x, tensors) for x in v], "tuple": isinstance(v, tuple)}
    if isinstance(v, VideoFeatures):
        return {"features": {f.name: _pack(getattr(v, f.name), tensors)
                             for f in dataclasses.fields(v)}}
    raise TypeError(f"a request value of type {type(v).__name__} cannot travel between ranks")


def _unpack(d: dict, tensors: list, device):
    """The value ``_pack`` described: arrays back to numpy, tensors on
    ``device`` where rank 0's were on a card."""
    if "v" in d:
        return d["v"]
    if "np" in d:
        return tensors[d["np"]].cpu().numpy()
    if "torch" in d:
        t = tensors[d["torch"]]
        return t.to(device) if d["cuda"] else t.cpu()
    if "seq" in d:
        items = [_unpack(x, tensors, device) for x in d["seq"]]
        return tuple(items) if d["tuple"] else items
    return VideoFeatures(**{k: _unpack(x, tensors, device) for k, x in d["features"].items()})


def _dev(x: np.ndarray, device) -> torch.Tensor:
    """Copying host -> device transfer of one of the server's numpy mirrors.
    The mirrors are mutated right after a dispatch, so the copy must be
    complete when this returns (never ``non_blocking`` from a mirror)."""
    return torch.from_numpy(np.array(x)).to(device)


def _compact_gap(
    k_all: torch.Tensor,  # [L, B, KV, S, D], updated in place
    v_all: torch.Tensor,
    final_len: torch.Tensor,  # [B] int
    dec_start: torch.Tensor,  # [B] int
    counts: torch.Tensor,  # [B] int — decoded tokens per slot (0 for free slots)
    ks_all=None,  # [L, B, KV, S] f32 scale planes of an int8 cache, updated in place
    vs_all=None,
) -> None:
    """Fold every slot's gap-region decode K/V (and scales) down onto its
    prefill tail.

    Column j of slot b reads from ``dec_start_b + (j - final_len_b)`` inside
    the fold window [final_len_b, final_len_b + c_b) and from itself
    elsewhere. Source and destination overlap, so each layer is gathered
    into a fresh [B, KV, S, D] buffer and copied back: the transient is one
    layer, not the cache."""
    s = k_all.shape[3]
    j = torch.arange(s, device=k_all.device)[None, :]
    fl, ds = final_len.to(torch.int64)[:, None], dec_start.to(torch.int64)[:, None]
    fold = (j >= fl) & (j < fl + counts.to(torch.int64)[:, None])
    src = torch.where(fold, ds + (j - fl), j).clamp(0, s - 1)  # [B, S]
    idx = src[:, None, :, None].expand(k_all.shape[1:])
    planes = [(buf, idx) for buf in (k_all, v_all)]
    if ks_all is not None:
        planes += [(buf, idx[..., 0]) for buf in (ks_all, vs_all)]
    for buf, ix in planes:
        for layer in range(buf.shape[0]):
            buf[layer].copy_(torch.gather(buf[layer], 2, ix))


@dataclasses.dataclass
class ServeResult:
    request_id: int
    tokens: np.ndarray  # generated ids (incl. the prefill's first token)
    arrival_s: float  # arrival time (relative to server start)
    prefill_start_s: float
    first_token_s: float  # prefill done = first token ready
    finish_s: float  # last token harvested
    cancelled: bool = False  # client disconnect (on_tokens returned False) or deadline
    error: str = ""  # online mode: the admission failed (the request never ran;
    #   cancelled is True too)

    @property
    def ttft_s(self) -> float:  # queue wait + prefill
        return self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s


class ContinuousServer:
    """Continuous-batching server over one engine (greedy or sampled).

    ``batch_slots`` concurrent decode lanes; ``segment_steps`` decode steps
    between admission points; ``prefill_bucket`` is the uniform decode-base
    column (default: the first admitted request's attention bucket) — a
    request whose own bucket exceeds it raises ``ValueError``.
    ``max_new_tokens`` is the server's default token budget; a request dict
    may carry its own. With ``interleave_prefill``, blind decode segments
    run between an admission's prefill steps (the engine's ``on_dispatch``
    hook), ``interleave_segments_per_hook`` of them per hook.
    ``vision_cache_slots`` / ``prefix_cache_slots`` size the LRU caches of
    keyed requests (0 = off); a prefix capture reserves
    ``prefix_reserve_tokens`` for later, longer questions. ``stats`` counts
    requests, tokens, segments, compactions and cache events.
    """

    def __init__(
        self,
        engine,
        batch_slots: int = 4,
        segment_steps: int = 16,
        max_new_tokens: Optional[int] = None,
        prefill_bucket: Optional[int] = None,
        gap_capacity: Optional[int] = None,
        interleave_prefill: bool = True,
        interleave_segments_per_hook: int = 1,
        decode_attn_impl: str = "auto",
        vision_cache_slots: int = 0,
        prefix_cache_slots: int = 0,
        prefix_reserve_tokens: int = 512,
    ):
        rt = engine.retake
        self.sampler = Sampler.from_config(rt, getattr(engine, "noise_fn", None))
        self.engine = engine
        self.tp = getattr(engine, "tp", None)
        self.cfg = getattr(engine.cfg, "text", engine.cfg)  # LLaVA: its text decoder
        self.vision_cache_slots = int(vision_cache_slots)
        self._vision_cache: Dict[str, object] = {}  # video_key -> VideoFeatures
        self.prefix_cache_slots = int(prefix_cache_slots)
        self.prefix_reserve = int(prefix_reserve_tokens)
        self._prefix_cache: Dict[str, object] = {}  # video_key -> VideoPrefix
        self._prefix_disabled = False  # set for good by PrefixUnsupported
        # written only by the serving loop's thread
        self.stats: Dict[str, int] = {
            "requests_admitted": 0, "requests_finished": 0,
            "requests_cancelled": 0, "requests_rejected_deadline": 0,
            "requests_failed": 0, "tokens_emitted": 0, "segments_dispatched": 0,
            "compactions": 0, "vision_cache_hits": 0, "vision_cache_misses": 0,
            "prefix_cache_hits": 0, "prefix_cache_misses": 0,
            "prefix_mismatch_fallbacks": 0, "prefix_capture_failures": 0,
            "prefix_budget_recaptures": 0,
        }
        self.b = int(batch_slots)
        self.seg = int(segment_steps)
        self.max_new = int(max_new_tokens or rt.max_new_tokens)
        self.p_bucket = prefill_bucket  # resolved at first admission
        self.gap_cap = int(gap_capacity or max(4 * self.seg, 128))
        self.interleave = bool(interleave_prefill)
        self.per_hook = max(1, int(interleave_segments_per_hook))
        if decode_attn_impl not in ("auto", "xla", "pallas", "flash"):
            raise ValueError("decode_attn_impl must be 'auto', 'xla', 'pallas' or 'flash', "
                             f"got {decode_attn_impl!r}")
        if decode_attn_impl == "auto":
            decode_attn_impl = batched_decode_impl(self.cfg, engine.device)
        self.decode_attn_impl = decode_attn_impl
        self.staged: List[torch.Tensor] = []  # un-harvested segment tokens [seg, B]
        self.emitted = np.zeros(self.b, np.int32)
        self.k_all = None  # allocated at the first admission
        self._slot_req = None
        self._drain = None

    # ---------- device / host state ----------

    def _gap_cols(self) -> int:
        """Physical gap columns: ``gap_cap`` plus the padding that makes the
        shared bucket a multiple of 2048. Only the buffer grows; the
        compaction trigger keeps ``gap_capacity``, so the write pointer
        never enters the padding."""
        s = self.p_bucket + self.gap_cap
        return self.gap_cap + (-s) % GAP_ALIGN

    def _init_buffers(self, st: PrefillState):
        l, kv, _, d = st.cache.k.shape
        self.device = st.cache.k.device
        s_attn = self.p_bucket + self._gap_cols()
        self.k_all = torch.zeros((l, self.b, kv, s_attn, d), dtype=st.cache.k.dtype,
                                 device=self.device)
        self.v_all = torch.zeros_like(self.k_all)
        self.ks_all = self.vs_all = None
        if st.cache.quantized:
            self.ks_all = torch.zeros(self.k_all.shape[:4], dtype=torch.float32,
                                      device=self.device)
            self.vs_all = torch.zeros_like(self.ks_all)
        # host-mirrored per-slot state (tiny vectors, uploaded per segment)
        self.base_t = np.zeros((l, self.b), np.int32)  # admission-adjusted
        self.pos_rest = np.zeros(self.b, np.int32)  # admission-adjusted
        self.final_len = np.zeros(self.b, np.int32)
        self.dec_start = np.full(self.b, self.p_bucket, np.int32)
        # the carry token stays on the device (last row of the previous
        # segment), so blind segments need no host read between dispatches
        self.cur_dev = torch.zeros(self.b, dtype=torch.int64, device=self.device)
        self.done = np.ones(self.b, bool)  # free slots decode as done
        self.f_global = 0  # decode steps since the last compaction
        self.emitted = np.zeros(self.b, np.int32)  # segment steps per tenant
        self.staged = []
        self.slot_max = np.full(self.b, self.max_new, np.int32)
        # sampling: slot b's request-own step = global step - step_off[b]
        self.step_off = np.zeros(self.b, np.int32)

    def _admit(self, slot: int, st: PrefillState, req_id: int):
        if st.attn_need > self.p_bucket:
            raise ValueError(
                f"request bucket {st.attn_need} exceeds server prefill bucket {self.p_bucket}"
            )
        cache = st.cache
        _insert_batch_slot(self.k_all, cache.k, slot)
        _insert_batch_slot(self.v_all, cache.v, slot)
        if self.ks_all is not None:
            _insert_batch_slot(self.ks_all, cache.k_scale, slot)
            _insert_batch_slot(self.vs_all, cache.v_scale, slot)
        fl = st.final_len
        if st.reforge:
            base_col = cache.pos[:, 0, fl - 1].cpu().numpy() + 1  # [L]
        else:
            base_col = np.full(self.base_t.shape[0], st.decode_pos_base)
        st.cache = None  # consumed
        # the loop computes base + (t0 + steps): subtract t0 now
        self.base_t[:, slot] = base_col - self.f_global
        self.pos_rest[slot] = st.decode_pos_base - self.f_global
        self.final_len[slot] = fl
        self.dec_start[slot] = self.p_bucket + self.f_global
        self.cur_dev[slot] = st.first_token_host
        self.emitted[slot] = 0
        self.step_off[slot] = self.f_global
        self.done[slot] = st.first_token_host == self.cfg.eos_token_id

    def _segment(self) -> None:
        """Enqueue ``seg`` decode steps and STAGE their token tensor (no host
        read here; the drain harvests). The next segment's carry token is
        the last row, copied: ``_admit`` writes into ``cur_dev``."""
        dev = self.device
        with span("serve.segment", live=len(self._slot_req or ()), steps=self.seg):
            tokens = _decode_loop_batch(
                self.engine.model, self.cfg, self.k_all, self.v_all,
                _dev(self.base_t, dev), _dev(self.pos_rest, dev), _dev(self.final_len, dev),
                self.p_bucket, self.cur_dev, self.seg, sampler=self.sampler,
                dec_start=_dev(self.dec_start, dev), i0=self.f_global,
                done0=_dev(self.done, dev), attn_impl=self.decode_attn_impl,
                ks_all=self.ks_all, vs_all=self.vs_all, step_off=self.step_off,
            )
            self.cur_dev = tokens[-1].clone()
        self.f_global += self.seg
        self.emitted = self.emitted + np.int32(self.seg)
        self.staged.append(tokens)
        self.stats["segments_dispatched"] += 1

    def _counts(self) -> np.ndarray:
        """Gap-region token count per slot = write-pointer distance since its
        dec_start (includes post-EOS tokens of not-yet-harvested slots: they
        are part of the slot's contiguous region and move with it)."""
        counts = np.zeros(self.b, np.int32)
        for s in self._slot_req or {}:
            counts[s] = self.p_bucket + self.f_global - self.dec_start[s]
        return counts

    def _on_prefill_dispatch(self):
        """Engine hook (interleaved chunked prefill): blind decode segments
        between an admission's prefill steps, so in-flight requests keep
        decoding. Skipped when a tenant could exceed its budget in a segment
        while others still need full ones."""
        slot_req = self._slot_req
        if not slot_req or self.k_all is None:
            return
        for _ in range(self.per_hook):
            if not slot_req:
                break
            need = [self.slot_max[s] - 1 - self.emitted[s] for s in slot_req]
            if max(need) <= 0:
                break  # every tenant's stream is already dispatched
            if any(n <= 0 for n in need):
                # a finished tenant must free before the next dispatch, or
                # later segments write junk K/V for it that a compaction
                # would fold past final_len + max_new <= P
                self._drain(keep_last=0)
                continue
            if max(need) > self.seg and any(0 < n < self.seg for n in need):
                break  # a final partial segment would overshoot: wait for the prefill
            if self.f_global + self.seg > self.gap_cap:
                self._compact(self._counts())
            self._segment()
        # harvest lag-1 (all but the segment just dispatched), or everything
        # when some tenant's stream is completely dispatched
        fin_any = any(self.slot_max[s] - 1 - self.emitted[s] <= 0 for s in slot_req)
        self._drain(keep_last=0 if fin_any else 1)

    def _compact(self, counts: np.ndarray):
        self.stats["compactions"] += 1
        dev = self.device
        with span("serve.compact", live=len(self._slot_req or ())):
            _compact_gap(self.k_all, self.v_all, _dev(self.final_len, dev),
                         _dev(self.dec_start, dev), _dev(counts, dev), self.ks_all, self.vs_all)
        self.final_len = self.final_len + counts.astype(np.int32)
        self.dec_start[:] = self.p_bucket
        # row0 = base + F: F resets, fold the consumed F into the bases
        self.base_t = self.base_t + np.int32(self.f_global)
        self.pos_rest = self.pos_rest + np.int32(self.f_global)
        self.step_off = self.step_off - np.int32(self.f_global)  # own = i - step_off
        self.f_global = 0

    # ---------- the serving loop ----------

    def run(
        self,
        requests: List[dict],
        arrival_times: Optional[List[float]] = None,
        on_tokens=None,
    ) -> List[ServeResult]:
        """Serve ``requests`` (``engine.generate`` kwargs, plus optional
        ``max_new_tokens`` and ``deadline_s``) arriving at ``arrival_times``
        (seconds from start, sorted; None = all at 0). Runs in real time: a
        request is visible once the wall clock passes its arrival. Returns
        one ``ServeResult`` per request, in request order.

        ``on_tokens(request_id, token_ids)`` streams tokens as the host
        harvests them: the first token at admission, then per harvested
        segment; the concatenation equals ``ServeResult.tokens``. A call
        returning ``False`` cancels that request (its slot frees at once).
        A request whose ``deadline_s`` (seconds from arrival) passes while
        it is queued is rejected without a prefill; one that passes in
        flight is cancelled at the next harvest."""
        n = len(requests)
        arrivals = list(arrival_times or [0.0] * n)
        if len(arrivals) != n or sorted(arrivals) != arrivals:
            raise ValueError("arrival_times must be sorted, one per request")
        results: List[Optional[ServeResult]] = [None] * n
        state = {"next": 0}

        def source(now, idle):
            i = state["next"]
            if i >= n:
                return "end", None
            if arrivals[i] > now():
                if not idle:
                    return "wait", None
                with span("serve.wait"):  # idle: block for the next arrival
                    time.sleep(max(0.0, arrivals[i] - now()))
            state["next"] = i + 1
            return "req", (requests[i], i, on_tokens, arrivals[i])

        if self.tp is not None:
            source = self._led_source(source, lambda i: (requests[i], i, None, arrivals[i]))
        self._serve_loop(source, lambda res: results.__setitem__(res.request_id, res))
        return results

    def _led_source(self, source, follow=None):
        """Under TP: rank 0 runs ``source`` and broadcasts each event as
        (event code, request id); the other ranks get their request from
        ``follow(request_id)`` (``run``: every rank holds the list) or, with
        no ``follow`` (online mode), from rank 0's ``_send_request``. Only
        rank 0 has ``on_tokens`` (it streams)."""
        tp = self.tp

        def led(now, idle):
            kind, payload = source(now, idle) if tp.rank == 0 else ("end", None)
            code = tp.broadcast_ints((_EVENTS.index(kind), -1 if payload is None else payload[1]))
            kind, rid = _EVENTS[code[0]], code[1]
            if kind != "req":
                return kind, None
            if follow is not None:
                return "req", payload if tp.rank == 0 else follow(rid)
            if tp.rank == 0:
                req, _, cb, arrival = payload
                return "req", (self._send_request(req), rid, cb, arrival)
            return "req", (self._recv_request(), rid, None, now())

        return led

    def _cached_features(self, cache: str, key):
        return self._vision_cache[key] if cache == "vision" else self._prefix_cache[key].features

    def _send_request(self, req: dict) -> dict:
        """Rank 0, online under TP: send ``req`` to the other ranks and
        return the request every rank admits. Features under a
        ``video_key`` still in a cache are not sent: every rank takes them
        from that cache (the HTTP front end peeked them earlier, and the
        entry may have gone since: then the tensors travel)."""
        tp, req = self.tp, dict(req)
        key, fields, tensors = req.get("video_key"), {}, []
        for name, v in req.items():
            cache = None
            if name == "video_features" and v is not None and key is not None:
                cache = ("vision" if key in self._vision_cache
                         else "prefix" if key in self._prefix_cache else None)
            if cache is not None:
                req[name] = self._cached_features(cache, key)
                fields[name] = {"cache": cache, "key": key}
            else:
                fields[name] = _pack(v, tensors)
        tp.broadcast_bytes(json.dumps({"fields": fields, "tensors": len(tensors)}).encode())
        for t in tensors:
            tp.broadcast_tensor(t)
        return req

    def _recv_request(self) -> dict:
        """The other ranks' side of ``_send_request``."""
        tp = self.tp
        msg = json.loads(tp.broadcast_bytes())
        tensors = [tp.broadcast_tensor() for _ in range(msg["tensors"])]
        return {name: (self._cached_features(d["cache"], d["key"]) if "cache" in d
                       else _unpack(d, tensors, self.engine.device))
                for name, d in msg["fields"].items()}

    def _lead(self, flags):
        """Rank 0's decisions (bools) on every rank under TP; as given at tp = 1."""
        if self.tp is None:
            return list(flags)
        return [bool(x) for x in self.tp.broadcast_ints([int(f) for f in flags] or [0])][: len(flags)]

    def _hook(self):
        return self._on_prefill_dispatch if self.interleave else None

    @staticmethod
    def _lru_put(cache: dict, key, value, slots: int) -> None:
        cache[key] = value
        while len(cache) > slots:
            cache.pop(next(iter(cache)))

    def _maybe_reuse_vision(self, req: dict) -> dict:
        """Swap a keyed request's pixels for its cached ``VideoFeatures``
        (encoding them on a miss, with the blind-segment hook); a request
        that carries its own ``video_features`` only bumps the LRU. Pixels
        are dropped only once features stand in for them."""
        req = dict(req)
        key = req.pop("video_key", None)
        if key is None or self.vision_cache_slots <= 0:
            return req
        if req.get("video_features") is not None:  # pinned by the caller
            self.stats["vision_cache_hits"] += 1
            self._vision_cache.pop(key, None)
            self._lru_put(self._vision_cache, key, req["video_features"], self.vision_cache_slots)
            return req
        feats = self._vision_cache.pop(key, None)  # pop + reinsert = LRU bump
        self.stats["vision_cache_hits" if feats is not None else "vision_cache_misses"] += 1
        if feats is None and req.get("pixel_values_videos") is not None:
            feats = self.engine.encode_video(req["pixel_values_videos"],
                                             req.get("video_grid_thw"), on_dispatch=self._hook())
        if feats is None:
            return req
        self._lru_put(self._vision_cache, key, feats, self.vision_cache_slots)
        req.pop("pixel_values_videos", None)
        req.pop("video_grid_thw", None)
        req["video_features"] = feats
        return req

    def _maybe_reuse_prefix(self, key, req: dict, req_max: int):
        """The cached ``VideoPrefix`` for ``key``, a fresh capture on a miss
        (sized for the largest budget the server allows so far), or None for
        the inline path: no key, cache off or disabled, a mixed image and
        video prompt, nothing to capture from, or a failed capture
        (``PrefixUnsupported`` disables the cache for good; a ``ValueError``
        fails only this capture)."""
        if key is None or self.prefix_cache_slots <= 0 or self._prefix_disabled:
            return None
        if req.get("pixel_values") is not None:
            return None  # image embeddings ride outside the captured prefix
        vp = self._prefix_cache.pop(key, None)
        if vp is not None:
            self._prefix_cache[key] = vp  # LRU bump
            self.stats["prefix_cache_hits"] += 1
            return vp
        self.stats["prefix_cache_misses"] += 1
        if req.get("pixel_values_videos") is None and req.get("video_features") is None:
            return None
        try:
            vp = self.engine.encode_prefix(
                req["input_ids"], req.get("pixel_values_videos"), req.get("video_grid_thw"),
                video_features=req.get("video_features"),
                max_new_tokens=max(self.max_new, req_max),
                reserve_tokens=self.prefix_reserve, on_dispatch=self._hook(),
            )
        except PrefixUnsupported:
            self.stats["prefix_capture_failures"] += 1
            self._prefix_disabled = True
            return None
        except ValueError:
            self.stats["prefix_capture_failures"] += 1
            return None
        self._lru_put(self._prefix_cache, key, vp, self.prefix_cache_slots)
        return vp

    def _prefill(self, req: dict, req_max: int, video_key) -> PrefillState:
        """One admission's prefill: a prefix hit runs only the question's
        suffix; ``PrefixMismatch`` falls back inline (on the prefix's own
        features when the request has no video), ``PrefixBudgetOverflow``
        evicts and recaptures first."""
        hook = self._hook()
        req = self._maybe_reuse_vision(req)
        vp = self._maybe_reuse_prefix(video_key, req, req_max)
        for attempt in range(2):  # the cached prefix, then at most one recapture
            if vp is None:
                break
            try:
                return self.engine.generate(req["input_ids"], prefix=vp, max_new_tokens=req_max,
                                            _prefill_only=True, on_dispatch=hook)
            except PrefixMismatch as pm:
                self.stats["prefix_mismatch_fallbacks"] += 1
                if req.get("pixel_values_videos") is None and req.get("video_features") is None:
                    req["video_features"] = vp.features
                if attempt or not isinstance(pm, PrefixBudgetOverflow):
                    break
            # the capture's budget is outgrown: recapture at this budget
            self._prefix_cache.pop(video_key, None)
            vp = self._maybe_reuse_prefix(video_key, req, req_max)
            if vp is not None:
                self.stats["prefix_budget_recaptures"] += 1
        return self.engine.generate(**{k: v for k, v in req.items() if k != "max_new_tokens"},
                                    max_new_tokens=req_max, _prefill_only=True, on_dispatch=hook)

    def start_online(self, max_queue: Optional[int] = None) -> "OnlineHandle":
        """Online mode: a worker thread runs the serving loop; ``submit()``
        from any thread returns a ``Future[ServeResult]`` (``on_tokens`` as
        in ``run``, cancel on False included). ``max_queue`` bounds the
        not-yet-admitted backlog: ``submit`` raises ``queue.Full`` past it.
        A request's ``deadline_s`` counts from its submission. One failed
        admission fails only its request (``ServeResult.error``).

        Under tensor parallelism every rank calls this (as ``run``): rank 0
        gets the handle callers submit to, every other rank a follower
        handle whose worker serves rank 0's requests (its ``submit``
        raises); rank 0's ``close`` ends every rank's worker."""
        return OnlineHandle(self, max_queue=max_queue)

    def _serve_loop(self, source, emit_result, isolate_errors: bool = False):
        """``source(now, idle)`` returns ("req", (req_dict, request_id,
        on_tokens, arrival_s)), ("wait", None) when nothing has arrived yet,
        or ("end", None); ``emit_result`` gets each ServeResult once. With
        ``isolate_errors`` (online mode) an exception while admitting one
        request fails only that request; ``run`` keeps fail-fast."""
        slot_req: Dict[int, int] = {}  # slot -> request id
        slot_tokens: Dict[int, list] = {}
        slot_meta: Dict[int, dict] = {}
        ended = False
        t0 = time.perf_counter()
        if self.tp is not None:  # under tp.check the ranks compare what they emit
            emit_rank = emit_result

            def emit_result(res: ServeResult):
                self.tp.note(res.tokens, res.cancelled)
                emit_rank(res)

        def now():
            return time.perf_counter() - t0

        def free_slots():
            return [s for s in range(self.b) if s not in slot_req]

        def admit_ready():
            nonlocal ended
            while not ended:
                drain_staged()  # may free slots finished in blind segments
                if not free_slots():
                    return
                kind, payload = source(now, idle=not slot_req)
                if kind == "end":
                    ended = True
                    return
                if kind == "wait":
                    return
                req, rid, cb, arrival = payload
                req = dict(req)
                deadline = req.pop("deadline_s", None)
                deadline = None if deadline is None else arrival + float(deadline)
                if deadline is not None and self._lead([now() > deadline])[0]:
                    self.stats["requests_rejected_deadline"] += 1
                    emit_result(ServeResult(
                        request_id=rid, tokens=np.zeros(0, np.int64), arrival_s=arrival,
                        prefill_start_s=now(), first_token_s=now(), finish_s=now(),
                        cancelled=True,
                    ))
                    continue
                t_pf = now()
                with span("serve.admit", request=rid):
                    error = None
                    calls = self.tp.calls if self.tp is not None else 0
                    try:
                        req_max = int(req.get("max_new_tokens") or self.max_new)
                        st = self._prefill(req, req_max, req.get("video_key"))
                    except Exception as e:  # the online worker's boundary: fail one request
                        if not isolate_errors:
                            raise
                        if self.tp is not None:
                            # failed alone only if every rank raised before any
                            # collective (the same replicated check); else the
                            # error may be this rank's alone and the ranks no
                            # longer pair their collectives: the worker ends
                            # here, and on the other ranks when their next
                            # collective times out or fails
                            if self.tp.calls != calls:
                                raise
                            self.tp.agree(1)  # returns once every rank failed it too
                        error = f"{type(e).__name__}: {e}"
                    else:  # every rank computed attn_need alike: no rank decides alone
                        if self.p_bucket is not None and st.attn_need > self.p_bucket:
                            msg = (f"request bucket {st.attn_need} exceeds server prefill bucket "
                                   f"{self.p_bucket} (max_new_tokens or video length too large "
                                   "for this server)")
                            if not isolate_errors:
                                raise ValueError(msg)
                            error = f"ValueError: {msg}"
                    if self.tp is not None and self.tp.check:
                        state = repr((list(self._vision_cache), list(self._prefix_cache),
                                      sorted(self.stats.items())))
                        self.tp.assert_replicated("admission",
                                                  np.frombuffer(state.encode(), np.uint8))
                    if error:
                        self.stats["requests_failed"] += 1
                        emit_result(ServeResult(
                            request_id=rid, tokens=np.zeros(0, np.int64), arrival_s=arrival,
                            prefill_start_s=t_pf, first_token_s=now(), finish_s=now(),
                            cancelled=True, error=error,
                        ))
                        continue
                    # blind segments staged during this prefill predate the
                    # admission: harvest them before the new tenant takes a slot
                    drain_staged()
                    if self.p_bucket is None:
                        self.p_bucket = st.attn_need
                    if self.k_all is None:
                        self._init_buffers(st)
                    slot = free_slots()[0]
                    self._admit(slot, st, rid)
                    self.slot_max[slot] = req_max
                    slot_req[slot] = rid
                    self.stats["requests_admitted"] += 1
                    slot_tokens[slot] = [st.first_token_host]
                    slot_meta[slot] = dict(arrival=arrival, prefill_start=t_pf,
                                           first_token=now(), on_tokens=cb, deadline=deadline)
                ret = cb(rid, [int(st.first_token_host)]) if cb is not None else None
                cancel = self._lead([ret is False])[0]
                if self.done[slot]:  # EOS at the first token (wins over a cancel)
                    finish(slot)
                elif cancel:  # cancelled at the first token
                    finish(slot, cancelled=True)

        def finish(slot, cancelled=False):
            i = slot_req.pop(slot)
            m = slot_meta.pop(slot)
            toks = slot_tokens.pop(slot)
            self.stats["requests_cancelled" if cancelled else "requests_finished"] += 1
            self.stats["tokens_emitted"] += len(toks)
            emit_result(ServeResult(
                request_id=i, tokens=np.asarray(toks), arrival_s=m["arrival"],
                prefill_start_s=m["prefill_start"], first_token_s=m["first_token"],
                finish_s=now(), cancelled=cancelled,
            ))
            self.done[slot] = True
            self.final_len[slot] = 0
            self.dec_start[slot] = self.p_bucket + self.f_global

        def drain_staged(keep_last: int = 0):
            """Harvest staged segment tokens in dispatch order: extend each
            live slot's stream, finish at EOS / budget / deadline / cancel
            (the cancels are rank 0's under TP)."""
            while len(self.staged) > keep_last:
                with span("serve.harvest", live=len(slot_req)):
                    harvest(self.staged.pop(0).cpu().numpy())  # [seg, B]

        def harvest(toks):
            ends = {}  # slot -> finished (stream complete), cancel wanted
            for slot in list(slot_req):
                buf = slot_tokens[slot]
                cb = slot_meta[slot]["on_tokens"]
                dl = slot_meta[slot]["deadline"]
                room = int(self.slot_max[slot]) - len(buf)
                if room <= 0:
                    ends[slot] = (True, False)
                    continue
                col = toks[:room, slot]
                eos = np.flatnonzero(col == self.cfg.eos_token_id)
                if len(eos):
                    col = col[: eos[0] + 1]
                buf.extend(col.tolist())
                finished = bool(len(eos)) or len(buf) >= int(self.slot_max[slot])
                ret = cb(slot_req[slot], col.tolist()) if cb is not None and len(col) else None
                ends[slot] = (finished, (dl is not None and now() > dl) or ret is False)
            cancels = self._lead([c for _, c in ends.values()])
            for (slot, (finished, _)), cancel in zip(ends.items(), cancels):
                if finished:  # a full stream wins over a same-segment cancel
                    finish(slot)
                elif cancel:
                    finish(slot, cancelled=True)

        self._slot_req = slot_req  # the prefill hook reads these
        self._drain = drain_staged
        try:
            while not ended or slot_req:
                admit_ready()
                if not slot_req:
                    continue
                if self.f_global + self.seg > self.gap_cap:
                    self._compact(self._counts())
                self._segment()
                drain_staged()
            if self.tp is not None:
                self.tp.assert_replicated("served")
        finally:
            self._slot_req = None
            self._drain = None


class OnlineHandle:
    """The dynamic-submission front of a ``ContinuousServer``
    (``start_online``): ``submit(request, on_tokens=None)`` from any thread
    returns a ``Future[ServeResult]``; one worker thread runs the serving
    loop and every device operation. ``close()`` stops admission, serves the
    requests in flight and joins the worker. A context manager.

    Under TP the handle of a rank other than 0 is a follower (``leader``
    False): its worker serves the requests rank 0 sends, ``submit`` raises,
    and ``close()`` only joins the worker, which ends when rank 0's handle
    closes. ``error`` holds the exception a worker died of."""

    def __init__(self, server: ContinuousServer, max_queue: Optional[int] = None):
        self.server = server
        self.leader = server.tp is None or server.tp.rank == 0
        self.error: Optional[BaseException] = None
        self.max_queue = max_queue
        self._q: queue.Queue = queue.Queue()
        self._futures: Dict[int, Future] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._work, daemon=True, name="retake-serve")
        self._thread.start()

    def submit(self, request: dict, on_tokens=None) -> Future:
        if not self.leader:
            raise RuntimeError(f"submit to rank 0: rank {self.server.tp.rank} serves the "
                               "requests rank 0 sends")
        if self.server.tp is not None:
            for v in request.values():  # TypeError here, not in the worker
                _pack(v, [])
        with self._lock:
            if self._closed:
                raise RuntimeError("OnlineHandle is closed")
            if self.max_queue is not None and self._q.qsize() >= self.max_queue:
                raise queue.Full(f"serving backlog at max_queue={self.max_queue}")
            rid = self._next_id
            self._next_id += 1
            fut: Future = Future()
            self._futures[rid] = fut
            # the put stays under the lock: every submission lands before
            # close()'s sentinel, and the max_queue check holds with it
            self._q.put((request, rid, on_tokens, time.perf_counter()))
        return fut

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop admission, drain the requests in flight, join the worker
        (``timeout`` bounds the join; the worker is alive after it only if
        the join timed out)."""
        with self._lock:
            if not self._closed and self.leader:
                self._q.put(None)  # under the lock: no submission after the sentinel
            self._closed = True
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _work(self):
        def source(now, idle):
            try:  # idle: wait (bounded) for a request or the sentinel; busy: poll
                if idle:
                    with span("serve.wait"):
                        item = self._q.get(timeout=IDLE_POLL_S)
                else:
                    item = self._q.get(block=False)
            except queue.Empty:
                return "wait", None
            if item is None:
                return "end", None
            req, rid, cb, t_submit = item
            return "req", (req, rid, cb, t_submit - time.perf_counter() + now())

        def emit(res: ServeResult):
            if not self.leader:
                return
            with self._lock:
                fut = self._futures.pop(res.request_id)
            fut.set_result(res)

        if self.server.tp is not None:
            source = self.server._led_source(source)
        exc: BaseException = RuntimeError("server closed before the request ran")
        try:
            with torch.no_grad():
                self.server._serve_loop(source, emit, isolate_errors=True)
        except BaseException as e:  # the worker died: fail every pending future
            exc = self.error = e
            raise
        finally:
            with self._lock:
                self._closed = True
                futs, self._futures = self._futures, {}
            for f in futs.values():
                if not f.done():
                    f.set_exception(exc)
