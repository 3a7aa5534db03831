"""The rest of serving, port against the JAX package on the CPU, fp32, same
weights (the JAX init through the port's weight bridge) and same requests
(numpy seed): the online mode (``start_online`` / ``OnlineHandle``), the
vision-feature and prefix caches of keyed requests (hits, LRU eviction,
the ``PrefixMismatch`` fallback, the budget recapture, ``PrefixUnsupported``
disabling the cache), deadlines, ``max_queue``, admission errors isolated
to their request, and the constructor options of the JAX server
(``interleave_prefill``, ``prefix_reserve_tokens``).

Tokens are held to the JAX engine's sequential ``generate`` (or the JAX
server's) exactly, ``stats`` to the JAX server's. The ports of
tests/test_serve.py's online and cache tests keep their names. Every wait
on a thread carries a timeout.
"""

import queue
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu.runtime import engine as jengine
from retake_tpu.runtime.engine import Qwen2VLEngine as JaxEngine
from retake_tpu.runtime.serve import ContinuousServer as JaxServer
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.runtime import engine as tengine
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.runtime.serve import ContinuousServer, ServeResult
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import port_cfg, port_params, tiny_cfg, video_request

# tests/test_serve.py's _build config: chunked prefill, PivotKV at 0.6 with
# position reforge
SERVE_RT = {"longvideo_kwargs": {
    "chunked_prefill_frames": 2, "frame_chunk_size": 2, "kvcache_compression": True,
    "kvcache_compression_kwargs": {"compression_ratio": 0.6, "pos_embed_reforge": True},
}}
GUIDED_RT = {"longvideo_kwargs": {
    "chunked_prefill_frames": 2, "frame_chunk_size": 2, "kvcache_compression": True,
    "kvcache_compression_kwargs": {"compression_ratio": 0.6, "prompt_guided_compression": True},
}}
WAIT = 300  # seconds: the bound of every wait on the worker


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg()
    jp = jparams.init_params(cfg, seed=0, dtype=jnp.float32)
    return cfg, jp, Qwen2VLModel(port_cfg(cfg), port_params(jp))


def _engines(tiny, rd=SERVE_RT):
    cfg, jp, model = tiny
    return (JaxEngine(cfg, jp, JaxRetakeConfig.from_dict(rd)),
            Qwen2VLEngine(port_cfg(cfg), model, RetakeConfig.from_dict(rd), device="cpu"))


def _req(ids, patches, grid, **kw):
    return dict(input_ids=ids, pixel_values_videos=patches, video_grid_thw=grid, **kw)


@pytest.fixture(scope="module")
def four(tiny):
    """tests/test_serve.py's four requests and their JAX sequential streams
    at 12 tokens (greedy streams are prefix-stable: a budget m takes the
    first m)."""
    rng = np.random.default_rng(0)
    reqs = [_req(*video_request(tiny[0], rng, grid_t=2 + 2 * (i % 2), prompt_len=4 + i))
            for i in range(4)]
    jeng, _ = _engines(tiny)
    return reqs, [jeng.generate(**r, max_new_tokens=12).tokens for r in reqs]


@pytest.fixture(scope="module")
def video(tiny):
    """One video and three questions about it (the last one 7 tokens long),
    a longer video and a text-only prompt; the JAX sequential streams at 8
    tokens."""
    cfg = tiny[0]
    rng = np.random.default_rng(5)
    ids1, patches, grid = video_request(cfg, rng, grid_t=2, prompt_len=4)
    vend = int(np.where(ids1 == cfg.video_token_id)[0][-1]) + 2
    ids2 = np.concatenate([ids1[:vend], rng.integers(10, 500, size=7)]).astype(np.int64)
    ids3, patches3, grid3 = video_request(cfg, rng, grid_t=4, prompt_len=4)
    text = rng.integers(10, 500, size=9).astype(np.int64)
    jeng, _ = _engines(tiny)
    seq = {
        "q1": jeng.generate(ids1, patches, grid, max_new_tokens=8).tokens,
        "q2": jeng.generate(ids2, patches, grid, max_new_tokens=8).tokens,
        "long": jeng.generate(ids3, patches3, grid3, max_new_tokens=8).tokens,
        "text": jeng.generate(text, max_new_tokens=8).tokens,
    }
    return dict(ids1=ids1, ids2=ids2, patches=patches, grid=grid, ids3=ids3,
                patches3=patches3, grid3=grid3, text=text), seq


def _close(handle):
    handle.close(timeout=WAIT)
    assert not handle._thread.is_alive()


def _counting_encode(monkeypatch):
    n = {"encode": 0}
    orig = Qwen2VLEngine.encode_video

    def counting(self, *a, **kw):
        n["encode"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(Qwen2VLEngine, "encode_video", counting)
    return n


# ---------------------------------------------------------------- online mode


def test_online_server_dynamic_submission(tiny, four):
    """submit() from the caller thread: futures resolve with the JAX
    sequential streams, later submissions enter while earlier ones decode,
    the streamed chunks concatenate to the tokens, close() drains, and a
    closed handle refuses."""
    reqs, seq = four
    _, eng = _engines(tiny)
    server = ContinuousServer(eng, batch_slots=2, segment_steps=3, max_new_tokens=9,
                              gap_capacity=6)
    chunks = {}

    def on_tokens(rid, toks):
        chunks.setdefault(rid, []).extend(toks)

    handle = server.start_online()
    try:
        futs = [handle.submit(r, on_tokens=on_tokens) for r in reqs[:2]]
        r0 = futs[0].result(timeout=WAIT)
        futs += [handle.submit(r, on_tokens=on_tokens) for r in reqs[2:]]
        results = [r0] + [f.result(timeout=WAIT) for f in futs[1:]]
    finally:
        _close(handle)
    for rid, (res, s) in enumerate(zip(results, seq)):
        assert res.request_id == rid and not res.cancelled and not res.error
        np.testing.assert_array_equal(res.tokens, s[:9])
        np.testing.assert_array_equal(np.asarray(chunks[rid]), s[:9])
        assert res.arrival_s <= res.prefill_start_s <= res.first_token_s
    assert server.stats["compactions"] >= 1 and server.stats["requests_finished"] == 4
    with pytest.raises(RuntimeError):
        handle.submit(reqs[0])


def test_online_server_cancel_and_close_idle(tiny, four):
    """on_tokens returning False mid-stream cancels and frees the lane; the
    next request still gets its JAX stream; closing an idle server joins."""
    reqs, seq = four
    _, eng = _engines(tiny)
    server = ContinuousServer(eng, batch_slots=2, segment_steps=2, max_new_tokens=12,
                              gap_capacity=64)
    seen = []

    def cancel_after_first_chunk(rid, toks):
        seen.extend(toks)
        return len(seen) <= 1

    handle = server.start_online()
    try:
        res = handle.submit(reqs[0], on_tokens=cancel_after_first_chunk).result(timeout=WAIT)
        assert res.cancelled and len(res.tokens) < 12
        np.testing.assert_array_equal(res.tokens, seq[0][: len(res.tokens)])
        res2 = handle.submit(reqs[1]).result(timeout=WAIT)
        assert not res2.cancelled
        np.testing.assert_array_equal(res2.tokens, seq[1])
    finally:
        _close(handle)
    assert server.stats["requests_cancelled"] == 1


def test_online_deadline_and_max_queue(tiny, four):
    """A queued request whose deadline passed is rejected without a
    prefill; submit() raises queue.Full at max_queue; an in-flight request
    past its deadline cancels at a harvest."""
    reqs, seq = four
    _, eng = _engines(tiny)
    server = ContinuousServer(eng, batch_slots=1, segment_steps=2, max_new_tokens=12,
                              gap_capacity=64)
    admitted = threading.Event()
    handle = server.start_online(max_queue=1)
    try:
        f0 = handle.submit(dict(reqs[0]), on_tokens=lambda rid, t: admitted.set())
        assert admitted.wait(timeout=WAIT)
        f1 = handle.submit(dict(reqs[1], deadline_s=0.0))
        with pytest.raises(queue.Full):
            handle.submit(dict(reqs[2], deadline_s=0.0))
        r0, r1 = f0.result(timeout=WAIT), f1.result(timeout=WAIT)
    finally:
        _close(handle)
    assert not r0.cancelled
    np.testing.assert_array_equal(r0.tokens, seq[0])
    assert r1.cancelled and len(r1.tokens) == 0
    assert server.stats["requests_rejected_deadline"] == 1
    assert server.stats["requests_admitted"] == 1

    # in flight: the idle server admits at once (the deadline is checked in
    # the queue and at each harvest); each harvest sleeps 0.02 s, so a
    # 200-token stream outlives the 2 s deadline whatever the machine
    server2 = ContinuousServer(eng, batch_slots=1, segment_steps=1, max_new_tokens=200,
                               gap_capacity=512)
    h2 = server2.start_online()
    try:
        h2.submit(dict(reqs[0], max_new_tokens=4)).result(timeout=WAIT)  # warm
        res = h2.submit(dict(reqs[0], deadline_s=2.0),
                        on_tokens=lambda rid, toks: time.sleep(0.02)).result(timeout=WAIT)
    finally:
        _close(h2)
    assert res.cancelled and 1 <= len(res.tokens) < 200
    np.testing.assert_array_equal(res.tokens[:12], seq[0][: len(res.tokens)])


def test_online_admission_error_isolated(tiny, four):
    """A bad request fails alone with ServeResult.error (and cancelled);
    the worker lives on and serves the next one; run() keeps fail-fast."""
    reqs, seq = four
    _, eng = _engines(tiny)
    server = ContinuousServer(eng, batch_slots=2, segment_steps=3, max_new_tokens=8,
                              gap_capacity=64)
    bad = {"input_ids": "not-an-array"}
    handle = server.start_online()
    try:
        res_bad = handle.submit(bad).result(timeout=WAIT)
        res_ok = handle.submit(reqs[0]).result(timeout=WAIT)
    finally:
        _close(handle)
    assert res_bad.cancelled and res_bad.error and len(res_bad.tokens) == 0
    assert not res_ok.cancelled and not res_ok.error
    np.testing.assert_array_equal(res_ok.tokens, seq[0][:8])
    assert server.stats["requests_failed"] == 1
    with pytest.raises(Exception):
        server.run([bad])


def test_online_over_bucket_request_fails_alone(tiny, four, monkeypatch):
    """Online, a request needing a bigger attention bucket than the server's
    fails with the bucket message; the loop serves the next request."""
    reqs, seq = four
    monkeypatch.setattr(tengine, "BUDGET_BUCKET", 64)
    _, eng = _engines(tiny)
    server = ContinuousServer(eng, batch_slots=2, segment_steps=3, max_new_tokens=4,
                              gap_capacity=64)
    handle = server.start_online()
    try:
        r0 = handle.submit(dict(reqs[0])).result(timeout=WAIT)
        r1 = handle.submit(dict(reqs[0], max_new_tokens=512)).result(timeout=WAIT)
        r2 = handle.submit(dict(reqs[0])).result(timeout=WAIT)
    finally:
        _close(handle)
    assert r1.error and "exceeds server prefill bucket" in r1.error and r1.cancelled
    np.testing.assert_array_equal(r0.tokens, seq[0][:4])
    np.testing.assert_array_equal(r2.tokens, r0.tokens)
    assert server.stats["requests_failed"] == 1


def test_online_worker_death_fails_pending_futures(tiny, four):
    """If the serving loop itself dies, every pending future fails with its
    exception and later submits raise instead of hanging."""
    reqs, _ = four
    _, eng = _engines(tiny)
    server = ContinuousServer(eng, batch_slots=1, segment_steps=2, max_new_tokens=6,
                              gap_capacity=64)
    gate = threading.Event()

    def boom():
        gate.wait(timeout=WAIT)
        raise RuntimeError("segment failed")

    server._segment = boom
    handle = server.start_online()
    try:
        futs = [handle.submit(dict(r)) for r in reqs[:2]]
        gate.set()
        for f in futs:
            with pytest.raises(RuntimeError, match="segment failed"):
                f.result(timeout=WAIT)
    finally:
        handle._thread.join(timeout=WAIT)
    assert not handle._thread.is_alive()
    with pytest.raises(RuntimeError):
        handle.submit(dict(reqs[0]))


# ---------------------------------------------------------------- the caches


def test_serve_vision_cache_reuses_encode(tiny, video, monkeypatch):
    """Two questions under one video_key encode the video once, with the
    JAX sequential streams; another key evicts (1 slot) and encodes anew."""
    v, seq = video
    n = _counting_encode(monkeypatch)
    _, eng = _engines(tiny)
    server = ContinuousServer(eng, batch_slots=2, segment_steps=3, max_new_tokens=8,
                              gap_capacity=64, vision_cache_slots=1)
    reqs = [_req(v[k], v["patches"], v["grid"], video_key="vidA") for k in ("ids1", "ids2")]
    results = server.run(reqs)
    assert n["encode"] == 1
    np.testing.assert_array_equal(results[0].tokens, seq["q1"])
    np.testing.assert_array_equal(results[1].tokens, seq["q2"])
    res2 = server.run([dict(reqs[0], video_key="vidB")])
    assert n["encode"] == 2 and list(server._vision_cache) == ["vidB"]
    np.testing.assert_array_equal(res2[0].tokens, seq["q1"])
    assert server.stats["vision_cache_hits"] == 1 and server.stats["vision_cache_misses"] == 2
    # features pinned by the caller (the HTTP cache peek) only bump the LRU
    feats = server._vision_cache["vidB"]
    res3 = server.run([dict(input_ids=v["ids2"], video_features=feats, video_key="vidB")])
    assert n["encode"] == 2 and server.stats["vision_cache_hits"] == 2
    np.testing.assert_array_equal(res3[0].tokens, seq["q2"])


def test_serve_prefix_cache_reuses_prefill(tiny, video, monkeypatch):
    """One capture serves later keyed questions (a pixel-less one too) with
    the JAX streams; a divergent video under the same key falls back inline
    (PrefixMismatch); a text-only keyed request takes the inline path."""
    v, seq = video
    n = _counting_encode(monkeypatch)
    _, eng = _engines(tiny)
    server = ContinuousServer(eng, batch_slots=2, segment_steps=3, max_new_tokens=8,
                              gap_capacity=64, prefix_cache_slots=1)
    reqs = [_req(v["ids1"], v["patches"], v["grid"], video_key="vidA"),
            _req(v["ids2"], v["patches"], v["grid"], video_key="vidA"),
            dict(input_ids=v["ids2"], video_key="vidA")]
    results = server.run(reqs)
    assert n["encode"] == 1
    assert server.stats["prefix_cache_hits"] == 2 and server.stats["prefix_cache_misses"] == 1
    for r, k in zip(results, ("q1", "q2", "q2")):
        np.testing.assert_array_equal(r.tokens, seq[k])
    res3 = server.run([_req(v["ids3"], v["patches3"], v["grid3"], video_key="vidA")])
    assert server.stats["prefix_mismatch_fallbacks"] == 1
    np.testing.assert_array_equal(res3[0].tokens, seq["long"])
    res_t = server.run([dict(input_ids=v["text"], video_key="vidT")])
    np.testing.assert_array_equal(res_t[0].tokens, seq["text"])


def test_serve_prefix_mismatch_without_pixels_uses_the_prefix_features(tiny, video):
    """A pixel-less keyed question whose plan diverges from the capture
    (another prompt prefix) falls back inline on the prefix's own features:
    the inline tokens, and the JAX server's stats."""
    cfg = tiny[0]
    v, _ = video
    other = v["ids2"].copy()
    other[0] += 1  # same video span, another text before it
    jeng, teng = _engines(tiny)
    reqs = [_req(v["ids1"], v["patches"], v["grid"], video_key="vidA"),
            dict(input_ids=other, video_key="vidA")]
    want = jeng.generate(other, v["patches"], v["grid"], max_new_tokens=8).tokens
    kw = dict(batch_slots=2, segment_steps=3, max_new_tokens=8, gap_capacity=64,
              prefix_cache_slots=1)
    jsrv, tsrv = JaxServer(jeng, **kw), ContinuousServer(teng, **kw)
    jres, tres = jsrv.run([dict(r) for r in reqs]), tsrv.run([dict(r) for r in reqs])
    np.testing.assert_array_equal(tres[1].tokens, want)
    np.testing.assert_array_equal(tres[1].tokens, jres[1].tokens)
    assert tsrv.stats["prefix_mismatch_fallbacks"] == 1
    assert tsrv.stats == dict(jsrv.stats, requests_failed=0)
    assert cfg.video_token_id in other


def test_serve_prefix_budget_overflow_recaptures(tiny, video, monkeypatch):
    """A request whose budget outgrows the capture evicts and recaptures it
    (one fallback, one recapture), with the JAX stream; the recaptured entry
    serves the same budget again as a plain hit."""
    v, _ = video
    monkeypatch.setattr(tengine, "BUDGET_BUCKET", 64)
    monkeypatch.setattr(jengine, "BUDGET_BUCKET", 64)
    jeng, eng = _engines(tiny)
    server = ContinuousServer(eng, batch_slots=2, segment_steps=3, max_new_tokens=4,
                              gap_capacity=64, prefix_cache_slots=1, prefill_bucket=1024)
    first = _req(v["ids1"], v["patches"], v["grid"], video_key="vidA")
    r1 = server.run([first])
    np.testing.assert_array_equal(
        r1[0].tokens, jeng.generate(v["ids1"], v["patches"], v["grid"], max_new_tokens=4).tokens)
    vp = server._prefix_cache["vidA"]
    big = vp.budget - vp.final_len + 8
    want = jeng.generate(v["ids1"], v["patches"], v["grid"], max_new_tokens=big).tokens
    r2 = server.run([dict(input_ids=v["ids1"], video_key="vidA", max_new_tokens=big)])
    assert server.stats["prefix_mismatch_fallbacks"] == 1
    assert server.stats["prefix_budget_recaptures"] == 1
    np.testing.assert_array_equal(r2[0].tokens, want)
    vp2 = server._prefix_cache["vidA"]
    assert vp2 is not vp and vp2.budget > vp.budget
    hits = server.stats["prefix_cache_hits"]
    r3 = server.run([dict(input_ids=v["ids1"], video_key="vidA", max_new_tokens=big)])
    assert server.stats["prefix_mismatch_fallbacks"] == 1
    assert server.stats["prefix_budget_recaptures"] == 1
    assert server.stats["prefix_cache_hits"] == hits + 1
    np.testing.assert_array_equal(r3[0].tokens, want)


def test_serve_prefix_unsupported_disables_cache(tiny, video):
    """Prompt-guided compression has no question-independent prefill: the
    first capture fails with PrefixUnsupported, the cache is off for good,
    and every request still gets the JAX stream."""
    v, _ = video
    jeng, eng = _engines(tiny, GUIDED_RT)
    want = jeng.generate(v["ids1"], v["patches"], v["grid"], max_new_tokens=6).tokens
    server = ContinuousServer(eng, batch_slots=2, segment_steps=3, max_new_tokens=6,
                              gap_capacity=64, prefix_cache_slots=1)
    req = _req(v["ids1"], v["patches"], v["grid"], video_key="vidA")
    res = server.run([dict(req), dict(req)])
    assert server.stats["prefix_capture_failures"] == 1 and server._prefix_disabled
    res2 = server.run([dict(req)])
    assert server.stats["prefix_capture_failures"] == 1
    assert server.stats["prefix_cache_misses"] == 1
    for r in res + res2:
        np.testing.assert_array_equal(r.tokens, want)


def test_serve_prefix_capture_value_error_fails_only_that_capture(tiny, video):
    """A keyed prompt that ends with its video span cannot be captured
    (ValueError): that capture fails, the cache stays on, the request is
    served inline; a later keyed question captures and hits."""
    cfg = tiny[0]
    v, seq = video
    vend = int(np.where(v["ids1"] == cfg.video_token_id)[0][-1]) + 1
    ends_with_video = v["ids1"][:vend]
    jeng, eng = _engines(tiny)
    want = jeng.generate(ends_with_video, v["patches"], v["grid"], max_new_tokens=8).tokens
    server = ContinuousServer(eng, batch_slots=2, segment_steps=3, max_new_tokens=8,
                              gap_capacity=64, prefix_cache_slots=1)
    res = server.run([_req(ends_with_video, v["patches"], v["grid"], video_key="vidA"),
                      _req(v["ids1"], v["patches"], v["grid"], video_key="vidA"),
                      dict(input_ids=v["ids2"], video_key="vidA")])
    assert server.stats["prefix_capture_failures"] == 1 and not server._prefix_disabled
    assert server.stats["prefix_cache_hits"] == 1
    np.testing.assert_array_equal(res[0].tokens, want)
    np.testing.assert_array_equal(res[1].tokens, seq["q1"])
    np.testing.assert_array_equal(res[2].tokens, seq["q2"])


def test_serve_stats_match_the_jax_server(tiny, video):
    """One keyed sequence through both caches (misses, hits, an LRU
    eviction, a mismatch fallback, a text-only request, a deadline
    rejection): the JAX server's tokens and its stats, key by key."""
    v, _ = video
    jeng, teng = _engines(tiny)
    reqs = [_req(v["ids1"], v["patches"], v["grid"], video_key="a"),
            _req(v["ids2"], v["patches"], v["grid"], video_key="a"),
            _req(v["ids3"], v["patches3"], v["grid3"], video_key="b"),
            dict(input_ids=v["ids2"], video_key="a"),
            _req(v["ids3"], v["patches3"], v["grid3"], video_key="a"),
            dict(input_ids=v["text"], video_key="t"),
            dict(input_ids=v["text"], deadline_s=0.0)]
    kw = dict(batch_slots=1, segment_steps=3, max_new_tokens=6, gap_capacity=64,
              vision_cache_slots=1, prefix_cache_slots=2)
    jsrv, tsrv = JaxServer(jeng, **kw), ContinuousServer(teng, **kw)
    jres = jsrv.run([dict(r) for r in reqs])
    tres = tsrv.run([dict(r) for r in reqs])
    for a, b in zip(tres, jres):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.cancelled == b.cancelled
    assert tsrv.stats == dict(jsrv.stats, requests_failed=jsrv.stats.get("requests_failed", 0))
    assert list(tsrv._vision_cache) == list(jsrv._vision_cache)
    assert list(tsrv._prefix_cache) == list(jsrv._prefix_cache)
    assert tsrv.stats["prefix_mismatch_fallbacks"] >= 1
    assert tsrv.stats["requests_rejected_deadline"] == 1


# ---------------------------------------------------------------- constructor options


def test_serve_interleave_prefill_off_matches_jax(tiny, four):
    """interleave_prefill=False: no engine hook and no blind segment during
    an admission; the JAX server's tokens and segment count."""
    reqs, seq = four
    jeng, teng = _engines(tiny)
    kw = dict(batch_slots=2, segment_steps=3, max_new_tokens=9, gap_capacity=6,
              interleave_prefill=False)
    hooks = []
    orig = teng.generate

    def spy(*a, **k):
        hooks.append(k.get("on_dispatch"))
        return orig(*a, **k)

    teng.generate = spy
    jsrv, tsrv = JaxServer(jeng, **kw), ContinuousServer(teng, **kw)
    jres = jsrv.run([dict(r) for r in reqs], arrival_times=[0.0, 0.0, 0.0, 0.01])
    tres = tsrv.run([dict(r) for r in reqs], arrival_times=[0.0, 0.0, 0.0, 0.01])
    assert hooks and all(h is None for h in hooks)
    for a, b, s in zip(tres, jres, seq):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, s[:9])
    assert tsrv.stats["segments_dispatched"] == jsrv.stats["segments_dispatched"]
    assert tsrv.stats["compactions"] == jsrv.stats["compactions"]


@pytest.mark.parametrize("reserve", [8, 700])
def test_serve_prefix_reserve_tokens_sizes_the_capture(tiny, video, reserve, monkeypatch):
    """prefix_reserve_tokens reaches encode_prefix: the captured budget and
    fill equal the JAX server's capture at the same reserve (budget bucket
    64, so the reserve moves the budget)."""
    v, seq = video
    monkeypatch.setattr(tengine, "BUDGET_BUCKET", 64)
    monkeypatch.setattr(jengine, "BUDGET_BUCKET", 64)
    jeng, teng = _engines(tiny)
    kw = dict(batch_slots=1, segment_steps=3, max_new_tokens=8, gap_capacity=64,
              prefix_cache_slots=1, prefix_reserve_tokens=reserve, prefill_bucket=1024)
    reqs = [_req(v["ids1"], v["patches"], v["grid"], video_key="a"),
            dict(input_ids=v["ids2"], video_key="a")]
    jsrv, tsrv = JaxServer(jeng, **kw), ContinuousServer(teng, **kw)
    jsrv.run([dict(r) for r in reqs])
    tres = tsrv.run([dict(r) for r in reqs])
    jvp, tvp = jsrv._prefix_cache["a"], tsrv._prefix_cache["a"]
    assert (tvp.budget, tvp.final_len) == (jvp.budget, jvp.final_len)
    assert tsrv.stats["prefix_cache_hits"] == 1
    np.testing.assert_array_equal(tres[1].tokens, seq["q2"])


def test_serve_result_error_field_and_defaults(tiny):
    """ServeResult carries the JAX fields (error defaults to ""), and the
    server takes the JAX constructor's keywords."""
    r = ServeResult(request_id=0, tokens=np.zeros(0), arrival_s=0.0, prefill_start_s=0.0,
                    first_token_s=0.0, finish_s=0.0)
    assert r.error == "" and not r.cancelled
    _, eng = _engines(tiny)
    srv = ContinuousServer(eng, interleave_prefill=False, prefix_reserve_tokens=64,
                           decode_attn_impl="flash", vision_cache_slots=2, prefix_cache_slots=3)
    assert (srv.interleave, srv.prefix_reserve, srv.decode_attn_impl) == (False, 64, "flash")
    jsrv = JaxServer(_engines(tiny)[0])
    assert set(srv.stats) == set(jsrv.stats) | {"requests_failed"}
