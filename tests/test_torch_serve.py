"""Port batched decode and continuous serving against the JAX package on the
CPU, fp32, same weights (the JAX init through the port's weight bridge) and
same requests (numpy seed): ``decode_step_batch`` and ``final_logits_batch``
(atol 1e-4 / 1e-5), ``_compact_gap`` (exact), ``generate_batch`` and
``ContinuousServer.run`` (exact tokens against the JAX engine's
``generate_batch``, the JAX server and the JAX sequential ``generate``), each
with a bf16 and an int8 KV cache (the int8 one's scale planes included).

The JAX references run once per module (module-scoped fixtures). Greedy
tokens are prefix-stable, so a request served at budget m is held against
the first m tokens of the JAX stream at a larger budget.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu.models.qwen2_vl import text as jtext
from retake_tpu.ops.quantization import quantize_kv_block as jquant_kv
from retake_tpu.runtime import engine as jengine
from retake_tpu.runtime.engine import Qwen2VLEngine as JaxEngine
from retake_tpu.runtime.serve import ContinuousServer as JaxServer
from retake_tpu.runtime.serve import _compact_gap as jcompact
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.models.qwen2_vl import text as ttext
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.ops import attention as tattn
from retake_tpu_torch.runtime import engine as tengine
from retake_tpu_torch.runtime import serve as tserve
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.runtime.serve import ContinuousServer
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import npy, port_cfg, port_params, tiny_cfg, tt, video_request

# the serving config of tests/test_serve.py: chunked prefill, PivotKV at a
# fixed ratio 0.6 with position reforge
SERVE_RT = {
    "longvideo_kwargs": {
        "chunked_prefill_frames": 2,
        "frame_chunk_size": 2,
        "kvcache_compression": True,
        "kvcache_compression_kwargs": {"compression_ratio": 0.6, "pos_embed_reforge": True},
    }
}
CHUNKED_RT = {"longvideo_kwargs": {"chunked_prefill_frames": 2, "frame_chunk_size": 2}}
MAX_NEW = 9  # the budget of the shared JAX reference streams
LONG_MAX_NEW = 40


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg()
    jp = jparams.init_params(cfg, seed=0, dtype=jnp.float32)
    return cfg, jp, Qwen2VLModel(port_cfg(cfg), port_params(jp))


def _engines(tiny, rd, cfg=None):
    cfg_j, jp, model = tiny
    cfg = cfg or cfg_j
    return (JaxEngine(cfg, jp, JaxRetakeConfig.from_dict(rd)),
            Qwen2VLEngine(port_cfg(cfg), model, RetakeConfig.from_dict(rd), device="cpu"))


def _req(ids, patches, grid, **kw):
    return dict(input_ids=ids, pixel_values_videos=patches, video_grid_thw=grid, **kw)


@pytest.fixture(scope="module")
def served(tiny):
    """Four requests of tests/test_serve.py's shape, their JAX sequential
    streams at MAX_NEW, and the JAX server's tokens under forced compactions."""
    cfg = tiny[0]
    rng = np.random.default_rng(0)
    reqs = [_req(*video_request(cfg, rng, grid_t=2 + 2 * (i % 2), prompt_len=4 + i))
            for i in range(4)]
    jeng, _ = _engines(tiny, SERVE_RT)
    seq = [jeng.generate(**r, max_new_tokens=MAX_NEW).tokens for r in reqs]
    jsrv = JaxServer(jeng, batch_slots=2, segment_steps=3, max_new_tokens=MAX_NEW,
                     gap_capacity=6)
    jres = jsrv.run([dict(r) for r in reqs])
    return reqs, seq, [r.tokens for r in jres]


@pytest.fixture(scope="module")
def long_set(tiny):
    """Two short requests and one long one (16 frames of 8x8 patches) and
    their JAX sequential streams at LONG_MAX_NEW: the long prefill is where
    the server runs blind decode segments."""
    cfg = tiny[0]
    rng = np.random.default_rng(1)
    reqs = [_req(*video_request(cfg, rng, grid_t=2, prompt_len=4)),
            _req(*video_request(cfg, rng, grid_t=2, prompt_len=6)),
            _req(*video_request(cfg, rng, grid_t=16, grid_h=8, grid_w=8, prompt_len=5))]
    jeng, _ = _engines(tiny, SERVE_RT)
    return reqs, [jeng.generate(**r, max_new_tokens=LONG_MAX_NEW).tokens for r in reqs]


def _server(tiny, **kw):
    _, eng = _engines(tiny, SERVE_RT)
    return ContinuousServer(eng, **kw)


def _assert_stream(got, want_full, budget):
    """``got`` is the greedy stream at ``budget``: the JAX stream's prefix,
    cut after its first EOS."""
    want = np.asarray(want_full)[:budget]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- decode step


def _step_inputs(cfg, rng, reforge):
    n_layers, b, kv, s, hd = cfg.num_hidden_layers, 3, cfg.num_key_value_heads, 64, cfg.head_dim
    k_all = (rng.normal(size=(n_layers, b, kv, s, hd)) * 0.5).astype(np.float32)
    v_all = (rng.normal(size=(n_layers, b, kv, s, hd)) * 0.5).astype(np.float32)
    hidden = (rng.normal(size=(b, cfg.hidden_size)) * 0.5).astype(np.float32)
    if reforge:  # per-layer temporal bases (after PivotKV eviction)
        base_t = rng.integers(20, 60, size=(n_layers, b)).astype(np.int32)
    else:
        base_t = np.broadcast_to(np.array([57, 61, 30], np.int32), (n_layers, b)).copy()
    pos_rest = np.array([57, 61, 30], np.int32) + 12
    return k_all, v_all, hidden, base_t, pos_rest


@pytest.mark.parametrize("reforge", [False, True])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_step_batch_matches_jax(tiny, rng, impl, reforge):
    """One batched step over a gap-layout cache (dec_start holes, a free
    slot): hidden and the new K/V blocks against JAX's same impl (its
    "pallas" arm in interpret mode); fp32, atol 1e-4."""
    cfg, jp, model = tiny
    k_all, v_all, hidden, base_t, pos_rest = _step_inputs(cfg, rng, reforge)
    fl, ds = np.array([10, 32, 0], np.int32), np.array([40, 44, 40], np.int32)
    jh, jk, jv = jtext.decode_step_batch(
        jp, cfg, jnp.asarray(k_all), jnp.asarray(v_all), jnp.asarray(hidden),
        jnp.asarray(base_t), jnp.asarray(pos_rest), jnp.asarray(fl), jnp.int32(40),
        jnp.int32(12), dec_start=jnp.asarray(ds), attn_impl=impl,
    )
    th, tk, tv = ttext.decode_step_batch(
        model, port_cfg(cfg), tt(k_all), tt(v_all), tt(hidden), tt(base_t), tt(pos_rest),
        tt(fl), 40, 12, dec_start=tt(ds), attn_impl=impl,
    )
    np.testing.assert_allclose(npy(th), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(npy(tk), np.asarray(jk), atol=1e-4)
    np.testing.assert_allclose(npy(tv), np.asarray(jv), atol=1e-4)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_step_batch_int8_matches_jax(tiny, rng, impl):
    """One batched step over an int8 gap-layout cache and its scale planes
    ([L, B, KV, S]; the JAX "pallas" arm takes them stacked with a layer
    index): hidden and the new (unquantized) K/V blocks; fp32, atol 1e-4."""
    cfg, jp, model = tiny
    k_all, v_all, hidden, base_t, pos_rest = _step_inputs(cfg, rng, True)
    (kq, ks), (vq, vs) = jquant_kv(jnp.asarray(k_all)), jquant_kv(jnp.asarray(v_all))
    fl, ds = np.array([10, 32, 0], np.int32), np.array([40, 44, 40], np.int32)
    jh, jk, jv = jtext.decode_step_batch(
        jp, cfg, kq, vq, jnp.asarray(hidden), jnp.asarray(base_t), jnp.asarray(pos_rest),
        jnp.asarray(fl), jnp.int32(40), jnp.int32(12), ks, vs, dec_start=jnp.asarray(ds),
        attn_impl=impl,
    )
    th, tk, tv = ttext.decode_step_batch(
        model, port_cfg(cfg), tt(kq), tt(vq), tt(hidden), tt(base_t), tt(pos_rest), tt(fl),
        40, 12, dec_start=tt(ds), attn_impl=impl, ks_all=tt(ks), vs_all=tt(vs),
    )
    np.testing.assert_allclose(npy(th), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(npy(tk), np.asarray(jk), atol=1e-4)
    np.testing.assert_allclose(npy(tv), np.asarray(jv), atol=1e-4)


def test_final_logits_batch_matches_jax(tiny, rng):
    cfg, jp, model = tiny
    h = rng.normal(size=(3, cfg.hidden_size)).astype(np.float32)
    np.testing.assert_allclose(
        npy(ttext.final_logits_batch(model, port_cfg(cfg), tt(h))),
        np.asarray(jtext.final_logits_batch(jp, cfg, jnp.asarray(h))), atol=1e-5,
    )


# ---------------------------------------------------------------- compaction


def test_compact_gap_matches_jax(rng):
    """The in-place per-layer gather == the JAX batched gather, bf16, every
    column (slot 2 is free: counts 0)."""
    n_layers, b, kv, s, d = 2, 3, 2, 24, 4
    k = rng.integers(-127, 127, size=(n_layers, b, kv, s, d)).astype(np.float32)
    v = rng.integers(-127, 127, size=(n_layers, b, kv, s, d)).astype(np.float32)
    final_len = np.array([5, 9, 0], np.int32)
    dec_start = np.array([14, 16, 12], np.int32)
    counts = np.array([4, 2, 0], np.int32)
    jk, jv, _, _ = jcompact(
        jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), None, None,
        jnp.asarray(final_len), jnp.asarray(dec_start), jnp.asarray(counts), jnp.int32(12),
    )
    tk, tv = tt(k).to(torch.bfloat16), tt(v).to(torch.bfloat16)
    tserve._compact_gap(tk, tv, tt(final_len), tt(dec_start), tt(counts))
    np.testing.assert_array_equal(npy(tk.float()), np.asarray(jk.astype(jnp.float32)))
    np.testing.assert_array_equal(npy(tv.float()), np.asarray(jv.astype(jnp.float32)))


def test_compact_gap_moves_kv_and_scales_like_jax(rng):
    """With an int8 cache the scale planes [L, B, KV, S] move with k/v: every
    column of k, v and both planes == the JAX batched gather, exactly."""
    n_layers, b, kv, s, d = 2, 3, 2, 24, 4
    k = rng.integers(-127, 127, size=(n_layers, b, kv, s, d)).astype(np.int8)
    v = rng.integers(-127, 127, size=(n_layers, b, kv, s, d)).astype(np.int8)
    ks, vs = (rng.random(size=(n_layers, b, kv, s)).astype(np.float32) for _ in range(2))
    final_len, dec_start = np.array([5, 9, 0], np.int32), np.array([14, 16, 12], np.int32)
    counts = np.array([4, 2, 0], np.int32)
    want = jcompact(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(final_len),
        jnp.asarray(dec_start), jnp.asarray(counts), jnp.int32(12),
    )
    got = [tt(x) for x in (k, v, ks, vs)]
    tserve._compact_gap(got[0], got[1], tt(final_len), tt(dec_start), tt(counts), got[2], got[3])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(npy(g), np.asarray(w))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_compaction_preserves_attention(rng, impl):
    """A decode step's attention over the cache before compaction equals the
    one after (entries relocated, dec_start reset, final_len grown): fp32,
    atol 3e-6 as the JAX test."""
    b, kv, g, d, s, gap_start, gap_filled = 2, 2, 2, 8, 64, 40, 8
    q = tt((rng.normal(size=(b, kv * g, d)) * 0.3).astype(np.float32))
    kc, vc = (tt((rng.normal(size=(1, b, kv, s, d)) * 0.3).astype(np.float32)) for _ in range(2))
    kn, vn = (tt((rng.normal(size=(b, kv, d)) * 0.3).astype(np.float32)) for _ in range(2))
    final_len, dec_start = np.array([10, 25], np.int32), np.array([43, 41], np.int32)
    counts = np.array([gap_start + gap_filled - x for x in dec_start], np.int32)
    pre = tattn.decode_attention_batch_gapped(
        q, kc[0], vc[0], tt(final_len), gap_start, gap_filled, kn, vn,
        dec_start=tt(dec_start), impl=impl,
    )
    tserve._compact_gap(kc, vc, tt(final_len), tt(dec_start), tt(counts))
    post = tattn.decode_attention_batch_gapped(
        q, kc[0], vc[0], tt(final_len + counts), gap_start, 0, kn, vn,
        dec_start=torch.full((b,), gap_start, dtype=torch.int32), impl=impl,
    )
    np.testing.assert_allclose(npy(post), npy(pre), atol=3e-6, rtol=3e-6)


# ---------------------------------------------------------------- generate_batch


def _batch_requests(cfg, rng, kind):
    if kind == "text_only":
        return [_req(*video_request(cfg, rng)),
                dict(input_ids=rng.integers(10, 500, size=9).astype(np.int64))]
    shapes = ((2, 5), (4, 3), (2, 8))
    reqs = [_req(*video_request(cfg, rng, grid_t=t, prompt_len=p)) for t, p in shapes]
    if kind == "per_request_max":
        for r, m in zip(reqs, (2, 6, 4)):
            r["max_new_tokens"] = m
    return reqs


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("kind", ["mixed", "text_only", "per_request_max"])
def test_generate_batch_matches_jax(tiny, kind, early_stop):
    """Sequential prefill + one batched decode: the JAX engine's
    generate_batch tokens exactly (mixed video lengths, a text-only request,
    per-request budgets), with the config's decode_early_stop on and off."""
    cfg = tiny[0]
    rd = dict(SERVE_RT if kind == "mixed" else CHUNKED_RT, decode_early_stop=early_stop)
    reqs = _batch_requests(cfg, np.random.default_rng(2), kind)
    jeng, teng = _engines(tiny, rd)
    want = jeng.generate_batch([dict(r) for r in reqs], max_new_tokens=6)
    got = teng.generate_batch([dict(r) for r in reqs], max_new_tokens=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        assert g.cache_len == w.cache_len


def test_decode_batch_early_stop_fires_like_jax(tiny):
    """Rebind EOS to a token the model emits so the early stop fires: the
    port's decode_batch (host check one step late) gives the JAX while-loop's
    tokens, shorter than the budget, with early stop on and off."""
    cfg, jp, model = tiny
    reqs = _batch_requests(cfg, np.random.default_rng(3), "mixed")[:2]
    jeng, teng = _engines(tiny, CHUNKED_RT)
    first = teng.generate_batch([dict(r) for r in reqs], max_new_tokens=8)
    cfg2 = dataclasses.replace(cfg, eos_token_id=int(first[0].tokens[2]))
    jeng, teng = _engines(tiny, CHUNKED_RT, cfg=cfg2)
    for early in (False, True):
        jst = [jeng.generate(**r, max_new_tokens=8, _prefill_only=True) for r in reqs]
        tst = [teng.generate(**r, max_new_tokens=8, _prefill_only=True) for r in reqs]
        want = jengine.decode_batch(jp, cfg2, jeng.retake, jst, 8, early_stop=early)
        got = tengine.decode_batch(model, port_cfg(cfg2), teng.retake, tst, 8, early_stop=early)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.tokens, w.tokens)
        assert min(len(g.tokens) for g in got) < 8
        assert all(st.cache is None for st in tst)  # consumed


def test_prefill_state_is_trimmed_to_its_bucket(tiny, monkeypatch):
    """generate(_prefill_only=True) returns the JAX PrefillState fields and
    a cache trimmed to its own decode bucket (budget buckets shrunk to 16
    on both sides so the tiny request has a bucket below its budget)."""
    cfg = tiny[0]
    monkeypatch.setattr(jengine, "BUDGET_BUCKET", 16)
    monkeypatch.setattr(tengine, "BUDGET_BUCKET", 16)
    req = _req(*video_request(cfg, np.random.default_rng(4), grid_t=4, prompt_len=30))
    jeng, teng = _engines(tiny, SERVE_RT)
    jst = jeng.generate(**req, max_new_tokens=5, _prefill_only=True)
    tst = teng.generate(**req, max_new_tokens=5, _prefill_only=True)
    for f in ("first_token_host", "decode_pos_base", "final_len", "reforge", "attn_need"):
        assert getattr(tst, f) == getattr(jst, f), f
    assert tst.cache.budget == tst.attn_need == jst.cache.budget
    n = tst.final_len
    np.testing.assert_allclose(npy(tst.cache.k[:, :, :n]), np.asarray(jst.cache.k[:, :, :n]),
                               atol=1e-4)
    np.testing.assert_array_equal(npy(tst.cache.pos[:, :, :n]), np.asarray(jst.cache.pos[:, :, :n]))


# ---------------------------------------------------------------- the server


def test_serve_forced_compactions_matches_jax(tiny, served):
    """All arrive at once, 2 slots for 4 requests, a gap capacity of 6
    forcing compactions: the JAX server's tokens and the JAX sequential
    streams, exactly."""
    reqs, seq, jserved = served
    srv = _server(tiny, batch_slots=2, segment_steps=3, max_new_tokens=MAX_NEW, gap_capacity=6)
    res = srv.run([dict(r) for r in reqs])
    assert srv.decode_attn_impl == "xla"  # "auto" on the CPU
    assert [r.request_id for r in res] == [0, 1, 2, 3]
    for r, j, s in zip(res, jserved, seq):
        np.testing.assert_array_equal(r.tokens, j)
        np.testing.assert_array_equal(r.tokens, s)
        assert 0 <= r.ttft_s <= r.latency_s
    assert srv.stats["compactions"] >= 1
    assert srv.stats["requests_finished"] == 4
    assert srv.stats["tokens_emitted"] == sum(len(s) for s in seq)


def test_serve_kernel_arm_matches_sequential(tiny, served):
    """decode_attn_impl="pallas" (on the CPU the K4 wrapper takes its plain
    twin): same admissions and compactions, the JAX sequential streams."""
    reqs, seq, _ = served
    srv = _server(tiny, batch_slots=2, segment_steps=3, max_new_tokens=MAX_NEW, gap_capacity=6,
                  decode_attn_impl="pallas")
    res = srv.run([dict(r) for r in reqs])
    assert srv.stats["compactions"] >= 1
    for r, s in zip(res, seq):
        np.testing.assert_array_equal(r.tokens, s)


def test_serve_staggered_admission(tiny, served):
    """A request arriving while the others decode is admitted into a slot
    freed mid-run (dec_start masks the slot's previous tenant)."""
    reqs, seq, _ = served
    srv = _server(tiny, batch_slots=2, segment_steps=2, max_new_tokens=MAX_NEW, gap_capacity=8)
    res = srv.run([dict(r) for r in reqs[:3]], arrival_times=[0.0, 0.0, 0.01])
    for r, s in zip(res, seq):
        np.testing.assert_array_equal(r.tokens, s)
    assert res[2].prefill_start_s >= min(res[0].finish_s, res[1].finish_s)


def test_serve_per_request_budgets(tiny, served):
    reqs, seq, _ = served
    budgets = [3, 9, 5, 9]
    srv = _server(tiny, batch_slots=2, segment_steps=3, max_new_tokens=MAX_NEW, gap_capacity=6)
    res = srv.run([dict(r, max_new_tokens=m) for r, m in zip(reqs, budgets)])
    for r, s, m in zip(res, seq, budgets):
        assert len(r.tokens) <= m
        _assert_stream(r.tokens, s, m)


def test_serve_streaming_callback(tiny, served):
    """The concatenated on_tokens chunks are each request's tokens."""
    reqs, seq, _ = served
    streamed = {}

    def on_tokens(rid, toks):
        streamed.setdefault(rid, []).extend(toks)

    srv = _server(tiny, batch_slots=2, segment_steps=3, max_new_tokens=MAX_NEW, gap_capacity=6)
    res = srv.run([dict(r) for r in reqs], on_tokens=on_tokens)
    for r, s in zip(res, seq):
        np.testing.assert_array_equal(r.tokens, np.asarray(streamed[r.request_id]))
        np.testing.assert_array_equal(r.tokens, s)


def test_serve_cancellation(tiny, served):
    """on_tokens returning False cancels: request 0 after its first decode
    chunk, request 1 at its first token; the freed lanes serve the rest and
    the other streams stay exact."""
    reqs, seq, _ = served
    calls = {}

    def on_tokens(rid, toks):
        calls.setdefault(rid, []).extend(toks)
        if rid == 1 or (rid == 0 and len(calls[0]) > 1):
            return False

    srv = _server(tiny, batch_slots=2, segment_steps=3, max_new_tokens=MAX_NEW, gap_capacity=6)
    res = srv.run([dict(r) for r in reqs], on_tokens=on_tokens)
    assert res[0].cancelled and 1 < len(res[0].tokens) < len(seq[0])
    np.testing.assert_array_equal(res[0].tokens, seq[0][: len(res[0].tokens)])
    assert res[1].cancelled and len(res[1].tokens) == 1
    for r, s in zip(res[2:], seq[2:]):
        assert not r.cancelled
        np.testing.assert_array_equal(r.tokens, s)
    assert srv.stats["requests_cancelled"] == 2 and srv.stats["requests_finished"] == 2


def test_serve_deadline_expired_in_queue(tiny, served):
    """With one slot busy, a request whose deadline passes while it waits is
    rejected without a prefill; the next one is served."""
    reqs, seq, _ = served
    srv = _server(tiny, batch_slots=1, segment_steps=3, max_new_tokens=MAX_NEW, gap_capacity=6)
    res = srv.run([dict(reqs[0]), dict(reqs[1], deadline_s=0.0), dict(reqs[2])])
    assert res[1].cancelled and len(res[1].tokens) == 0
    assert srv.stats["requests_rejected_deadline"] == 1
    assert srv.stats["requests_admitted"] == 2
    for i in (0, 2):
        np.testing.assert_array_equal(res[i].tokens, seq[i])


def test_serve_rejects_over_bucket_request(tiny, served, monkeypatch):
    """The slot buffers are sized at the first admission: a later request
    needing a bigger attention bucket raises ValueError."""
    reqs, _, _ = served
    monkeypatch.setattr(tengine, "BUDGET_BUCKET", 64)
    srv = _server(tiny, batch_slots=2, segment_steps=3, max_new_tokens=4, gap_capacity=64)
    with pytest.raises(ValueError, match="exceeds server prefill bucket"):
        srv.run([dict(reqs[0]), dict(reqs[0], max_new_tokens=512)])


def test_serve_runs_blind_segments_during_long_prefill(tiny, long_set):
    """While the long request prefills, the engine's dispatch hook runs
    decode segments for the live slot (compacting on the way: gap capacity
    8); both streams stay exact."""
    reqs, seq = long_set
    srv = _server(tiny, batch_slots=2, segment_steps=2, max_new_tokens=LONG_MAX_NEW,
                  gap_capacity=8)
    blind = 0
    orig = srv._on_prefill_dispatch

    def spy():
        nonlocal blind
        before = srv.stats["segments_dispatched"]
        orig()
        blind += srv.stats["segments_dispatched"] - before

    srv._on_prefill_dispatch = spy
    res = srv.run([dict(reqs[0]), dict(reqs[2])])
    assert blind > 0, "no blind segments ran during the long prefill"
    assert srv.stats["compactions"] >= 1
    np.testing.assert_array_equal(res[0].tokens, seq[0])
    np.testing.assert_array_equal(res[1].tokens, seq[2])


def test_serve_tenant_completes_mid_admission(tiny, long_set):
    """A short tenant whose budget fits in the blind segments finishes
    during the long admission, before the long request's first token."""
    reqs, seq = long_set
    srv = _server(tiny, batch_slots=2, segment_steps=2, max_new_tokens=LONG_MAX_NEW,
                  gap_capacity=8, interleave_segments_per_hook=4)
    res = srv.run([dict(reqs[0], max_new_tokens=7), dict(reqs[2])])
    _assert_stream(res[0].tokens, seq[0], 7)
    np.testing.assert_array_equal(res[1].tokens, seq[2])
    assert res[0].finish_s < res[1].first_token_s


def test_serve_mixed_completion_drains_before_dispatch(tiny, long_set):
    """Two live tenants with different budgets under a long admission, three
    segments per hook and compactions: the one that completes is drained
    before the next blind dispatch; every stream stays exact."""
    reqs, seq = long_set
    srv = _server(tiny, batch_slots=3, segment_steps=3, max_new_tokens=12, gap_capacity=9,
                  interleave_segments_per_hook=3)
    res = srv.run([dict(reqs[0], max_new_tokens=7), dict(reqs[1], max_new_tokens=17),
                   dict(reqs[2])])
    for r, s, m in zip(res, seq, (7, 17, 12)):
        _assert_stream(r.tokens, s, m)
    assert res[0].finish_s < res[2].first_token_s


INT8_KV_RT = {"kv_cache_dtype": "int8", **CHUNKED_RT}


@pytest.fixture(scope="module")
def int8_served(tiny):
    """Three requests of tests/test_serve.py's int8-KV shape and the JAX
    engine's sequential int8-KV streams at 8 tokens."""
    cfg = tiny[0]
    rng = np.random.default_rng(6)
    reqs = [_req(*video_request(cfg, rng, grid_t=t, prompt_len=p)) for t, p in ((2, 4), (4, 6), (2, 7))]
    jeng, _ = _engines(tiny, INT8_KV_RT)
    return reqs, [jeng.generate(**r, max_new_tokens=8).tokens for r in reqs]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_serve_int8_kv_matches_sequential(tiny, int8_served, impl):
    """An int8 KV cache under continuous batching (2 slots, 3 requests):
    admission inserts the scale planes, every step writes them; with no
    compaction (gap capacity 64) the tokens are the JAX engine's
    sequential int8-KV streams exactly, with the plain arm and with K4's
    int8 mode (its plain twin on the CPU), as tests/test_serve.py holds the
    JAX server."""
    reqs, seq = int8_served
    _, eng = _engines(tiny, INT8_KV_RT)
    srv = ContinuousServer(eng, batch_slots=2, segment_steps=3, max_new_tokens=8,
                           gap_capacity=64, decode_attn_impl=impl)
    res = srv.run([dict(r) for r in reqs])
    assert srv.ks_all is not None and srv.k_all.dtype == torch.int8
    assert srv.stats["compactions"] == 0
    for r, s in zip(res, seq):
        np.testing.assert_array_equal(r.tokens, s)


def test_serve_int8_kv_compacts_scale_planes(tiny, int8_served):
    """Forced compactions (gap capacity 6) with an int8 cache: every request
    still gets its full budget of in-vocabulary tokens, and the compaction
    moved scales with the keys (each live slot's folded columns carry a
    nonzero scale). Tokens are not held to the sequential stream here:
    compaction reorders fp sums, and int8-coarsened logits sit on near-ties
    (tests/test_serve.py::test_continuous_serve_int8_kv)."""
    reqs, _ = int8_served
    _, eng = _engines(tiny, INT8_KV_RT)
    srv = ContinuousServer(eng, batch_slots=2, segment_steps=3, max_new_tokens=8,
                           gap_capacity=6)
    folds = []
    orig = srv._compact

    def spy(counts):
        orig(counts)
        folds.append((srv.final_len.copy(), srv.ks_all.clone()))

    srv._compact = spy
    res = srv.run([dict(r) for r in reqs])
    assert folds, "no compaction ran"
    for final_len, ks_all in folds:
        for slot, n in enumerate(final_len):
            assert (ks_all[:, slot, :, :n] > 0).all()
    for r in res:
        assert 1 <= len(r.tokens) <= 8 and ((r.tokens >= 0) & (r.tokens < 512)).all()


def test_serve_gap_cols_align_the_bucket(tiny):
    srv = _server(tiny)
    for p_bucket, want in ((40960, 43008), (32768, 34816), (8192, 10240)):
        srv.p_bucket = p_bucket
        assert p_bucket + srv._gap_cols() == want


def test_serve_decode_attn_impl_auto(tiny):
    """"auto": the plain arm on the CPU; K4 for an engine on CUDA whose GQA
    group fits the kernel; the plain arm for a wider group."""
    _, eng = _engines(tiny, SERVE_RT)
    assert ContinuousServer(eng).decode_attn_impl == "xla"
    assert ContinuousServer(eng, decode_attn_impl="pallas").decode_attn_impl == "pallas"

    def fake(heads):
        cfg = dataclasses.replace(eng.cfg, num_attention_heads=heads, num_key_value_heads=2)
        return type("E", (), {"cfg": cfg, "retake": eng.retake,
                              "device": torch.device("cuda")})()

    assert ContinuousServer(fake(12)).decode_attn_impl == "pallas"
    assert ContinuousServer(fake(36)).decode_attn_impl == "xla"
    with pytest.raises(ValueError):
        ContinuousServer(eng, decode_attn_impl="flash")


def test_serve_rejects_paths_not_ported(tiny, served):
    reqs, _, _ = served
    _, eng = _engines(tiny, SERVE_RT)
    for kw in ({"vision_cache_slots": 1}, {"prefix_cache_slots": 1}):
        with pytest.raises(NotImplementedError):
            ContinuousServer(eng, **kw)
    with pytest.raises(NotImplementedError):
        ContinuousServer(eng).start_online()
    fake = type("E", (), {"cfg": eng.cfg, "device": eng.device,
                          "retake": RetakeConfig.from_dict({"do_sample": True})})()
    with pytest.raises(NotImplementedError):
        ContinuousServer(fake)
    with pytest.raises(ValueError):
        ContinuousServer(eng).run([dict(reqs[0]), dict(reqs[1])], arrival_times=[1.0, 0.0])
