"""Continuous batching: admit new requests mid-decode
(port of ``retake_tpu/runtime/serve.py``, greedy; bf16 or int8 KV cache).

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
otherwise.

Not ported yet (raise NotImplementedError): the vision-feature and prefix
caches (``vision_cache_slots`` / ``prefix_cache_slots``), the online mode
(``start_online``) and sampling.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from retake_tpu_torch.ops.cuda import decode_gapped
from retake_tpu_torch.runtime.engine import (
    PrefillState,
    _decode_loop_batch,
    _insert_batch_slot,
    _not_ported,
)

GAP_ALIGN = 2048  # the shared bucket (prefill bucket + gap) is a multiple of this


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

    @property
    def ttft_s(self) -> float:  # queue wait + prefill
        return self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s


class ContinuousServer:
    """Continuous-batching server over one engine (greedy decoding).

    ``batch_slots`` concurrent decode lanes; ``segment_steps`` decode steps
    between admission points; ``prefill_bucket`` is the uniform decode-base
    column (default: the first admitted request's attention bucket) — a
    request whose own bucket exceeds it raises ``ValueError``.
    ``max_new_tokens`` is the server's default token budget; a request dict
    may carry its own. Blind decode segments run between an admission's
    prefill steps (the engine's ``on_dispatch`` hook),
    ``interleave_segments_per_hook`` of them per hook.
    """

    def __init__(
        self,
        engine,
        batch_slots: int = 4,
        segment_steps: int = 16,
        max_new_tokens: Optional[int] = None,
        prefill_bucket: Optional[int] = None,
        gap_capacity: Optional[int] = None,
        interleave_segments_per_hook: int = 1,
        decode_attn_impl: str = "auto",
        vision_cache_slots: int = 0,
        prefix_cache_slots: int = 0,
    ):
        if vision_cache_slots > 0:
            raise _not_ported("the serving vision-feature cache (vision_cache_slots)")
        if prefix_cache_slots > 0:
            raise _not_ported("the serving prefix cache (prefix_cache_slots)")
        rt = engine.retake
        if rt.do_sample:
            raise _not_ported("sampled serving (do_sample)")
        self.engine = engine
        self.cfg = engine.cfg
        self.stats: Dict[str, int] = {
            "requests_admitted": 0, "requests_finished": 0,
            "requests_cancelled": 0, "requests_rejected_deadline": 0,
            "tokens_emitted": 0, "segments_dispatched": 0, "compactions": 0,
        }
        self.b = int(batch_slots)
        self.seg = int(segment_steps)
        self.max_new = int(max_new_tokens or rt.max_new_tokens)
        self.p_bucket = prefill_bucket  # resolved at first admission
        self.gap_cap = int(gap_capacity or max(4 * self.seg, 128))
        self.per_hook = max(1, int(interleave_segments_per_hook))
        if decode_attn_impl not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"decode_attn_impl must be 'auto', 'xla' or 'pallas', got {decode_attn_impl!r}"
            )
        if decode_attn_impl == "auto":
            group = self.cfg.num_attention_heads // self.cfg.num_key_value_heads
            on_cuda = torch.device(engine.device).type == "cuda"
            fits = group <= decode_gapped.MAX_GROUP
            decode_attn_impl = "pallas" if on_cuda and fits else "xla"
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
        self.done[slot] = st.first_token_host == self.cfg.eos_token_id

    def _segment(self) -> None:
        """Enqueue ``seg`` decode steps and STAGE their token tensor (no host
        read here; the drain harvests). The next segment's carry token is
        the last row, copied: ``_admit`` writes into ``cur_dev``."""
        dev = self.device
        tokens = _decode_loop_batch(
            self.engine.model, self.cfg, self.k_all, self.v_all,
            _dev(self.base_t, dev), _dev(self.pos_rest, dev), _dev(self.final_len, dev),
            self.p_bucket, self.cur_dev, self.seg,
            dec_start=_dev(self.dec_start, dev), i0=self.f_global,
            done0=_dev(self.done, dev), attn_impl=self.decode_attn_impl,
            ks_all=self.ks_all, vs_all=self.vs_all,
        )
        self.f_global += self.seg
        self.cur_dev = tokens[-1].clone()
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
        _compact_gap(self.k_all, self.v_all, _dev(self.final_len, dev),
                     _dev(self.dec_start, dev), _dev(counts, dev), self.ks_all, self.vs_all)
        self.final_len = self.final_len + counts.astype(np.int32)
        self.dec_start[:] = self.p_bucket
        # row0 = base + F: F resets, fold the consumed F into the bases
        self.base_t = self.base_t + np.int32(self.f_global)
        self.pos_rest = self.pos_rest + np.int32(self.f_global)
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
                time.sleep(arrivals[i] - now())  # idle: block for the next arrival
            state["next"] = i + 1
            return "req", (requests[i], i, on_tokens, arrivals[i])

        self._serve_loop(source, lambda res: results.__setitem__(res.request_id, res))
        return results

    def start_online(self, max_queue: Optional[int] = None):
        raise _not_ported("the online serving mode (start_online)")

    def _serve_loop(self, source, emit_result):
        """``source(now, idle)`` returns ("req", (req_dict, request_id,
        on_tokens, arrival_s)), ("wait", None) when nothing has arrived yet,
        or ("end", None); ``emit_result`` gets each ServeResult once."""
        slot_req: Dict[int, int] = {}  # slot -> request id
        slot_tokens: Dict[int, list] = {}
        slot_meta: Dict[int, dict] = {}
        ended = False
        t0 = time.perf_counter()

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
                req.pop("video_key", None)  # keys only address the caches not ported
                deadline = req.pop("deadline_s", None)
                deadline = None if deadline is None else arrival + float(deadline)
                if deadline is not None and now() > deadline:
                    self.stats["requests_rejected_deadline"] += 1
                    emit_result(ServeResult(
                        request_id=rid, tokens=np.zeros(0, np.int64), arrival_s=arrival,
                        prefill_start_s=now(), first_token_s=now(), finish_s=now(),
                        cancelled=True,
                    ))
                    continue
                t_pf = now()
                req_max = int(req.pop("max_new_tokens", None) or self.max_new)
                st = self.engine.generate(
                    **req, max_new_tokens=req_max, _prefill_only=True,
                    on_dispatch=self._on_prefill_dispatch,
                )
                if self.p_bucket is not None and st.attn_need > self.p_bucket:
                    raise ValueError(
                        f"request bucket {st.attn_need} exceeds server prefill bucket "
                        f"{self.p_bucket} (max_new_tokens or video length too large "
                        "for this server)"
                    )
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
                if self.done[slot]:  # EOS at the first token (wins over a cancel)
                    finish(slot)
                elif ret is False:  # cancelled at the first token
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
            live slot's stream, finish at EOS / budget / deadline / cancel."""
            while len(self.staged) > keep_last:
                toks = self.staged.pop(0).cpu().numpy()  # [seg, B]
                for slot in list(slot_req):
                    buf = slot_tokens[slot]
                    cb = slot_meta[slot]["on_tokens"]
                    dl = slot_meta[slot]["deadline"]
                    room = int(self.slot_max[slot]) - len(buf)
                    if room <= 0:
                        finish(slot)
                        continue
                    col = toks[:room, slot]
                    eos = np.flatnonzero(col == self.cfg.eos_token_id)
                    if len(eos):
                        col = col[: eos[0] + 1]
                    buf.extend(col.tolist())
                    finished = bool(len(eos)) or len(buf) >= int(self.slot_max[slot])
                    ret = cb(slot_req[slot], col.tolist()) if cb is not None and len(col) else None
                    if finished:  # a full stream wins over a same-segment cancel
                        finish(slot)
                    elif dl is not None and now() > dl:
                        finish(slot, cancelled=True)
                    elif ret is False:
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
        finally:
            self._slot_req = None
            self._drain = None
