"""Online serving (``ContinuousServer.start_online``) and the HTTP front end
(``RetakeHTTPServer``) under tensor parallelism, on the CPU, fp32, the tiny
Qwen2-VL, tp = 2 as two thread ranks (``run_ranks`` of
tests/test_torch_parallel.py: a ``ProcessGroupGloo`` each over one store,
``check`` on, so after every admission the ranks compare their cache keys,
``stats`` and emitted tokens).

Rank 0 takes the submissions and sends each request it admits to rank 1;
rank 1's follower worker serves it in lockstep. Tokens are held to the JAX
tp = 2 engine's sequential ``generate`` on the 8-device virtual CPU mesh,
cache ``stats`` to the port's tp = 1 online server on the same submission
sequence. Also: features evicted between the HTTP build and the admission
(they travel as tensors) against features still cached (they do not);
deadlines, ``max_queue``, an admission error failing its request on both
ranks, a rank-local failure ending both workers within the group's timeout,
``close()`` on both ranks; HTTP miss then prefix hit, blocking and
streamed. Every wait carries a timeout.
"""

import datetime
import json
import queue
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

from retake_tpu_torch.data.processor import Qwen2VLProcessor
from retake_tpu_torch.data.video import fetch_video
from retake_tpu_torch.parallel import TensorParallel
from retake_tpu_torch.runtime.http_server import RetakeHTTPServer
from retake_tpu_torch.runtime.serve import ContinuousServer
from test_torch_parallel import (  # noqa: F401  (fixtures: tiny, one_torch_thread)
    JOIN_S,
    _prefix_request,
    jax_tp_engine,
    one_torch_thread,
    port_engine,
    run_ranks,
    tiny,
)

WAIT = JOIN_S  # every future, join and HTTP call in a rank is bounded by this
# tests/test_torch_reuse.py's prefix config in fp32: DPSelect dropping
# frames, PivotKV with reforge
ONLINE_RT = {"longvideo_kwargs": {
    "frame_chunk_size": 4, "chunked_prefill_frames": 2, "visual_compression": True,
    "visual_compression_kwargs": {"compression_ratio": 0.5, "return_keyframe_mask": True},
    "kvcache_compression": True,
    "kvcache_compression_kwargs": {"compression_method": "pivotkv", "pos_embed_reforge": True,
                                   "compression_ratio": 0.5}}}
NEW = 6
KW = dict(batch_slots=2, segment_steps=3, max_new_tokens=NEW, gap_capacity=6)


def _req(ids, patches=None, grid=None, **kw):
    out = dict(input_ids=ids, **kw)
    if patches is not None:
        out.update(pixel_values_videos=patches, video_grid_thw=grid)
    return out


@pytest.fixture(scope="module")
def videos(tiny):
    """Two videos (A, B; 4 frames each) and three questions (two about A,
    one about B), with the JAX tp = 2 engine's sequential streams."""
    rng = np.random.default_rng(31)
    a1, pa, grid = _prefix_request(tiny.cfg, rng, [20, 21, 22, 23, 24])
    a2 = _prefix_request(tiny.cfg, rng, [30, 31, 32, 33, 34, 35, 36, 37])[0]
    b1, pb, _ = _prefix_request(tiny.cfg, rng, [40, 41, 42])
    q = {"a1": (a1, pa), "a2": (a2, pa), "b1": (b1, pb)}
    with jax.set_mesh(tiny.mesh):
        jeng = jax_tp_engine(tiny, tiny.jp, ONLINE_RT)
        want = {k: np.asarray(jeng.generate(ids, p, grid, max_new_tokens=NEW).tokens)
                for k, (ids, p) in q.items()}
    return q, grid, want


def _serve_online(tiny, requests, tp=None, max_queue=None, **kw):
    """``requests`` submitted one at a time, each awaited, on a fresh
    server (rank 0 or tp = 1); another rank follows. Returns the results
    (rank 0) and the server."""
    server = ContinuousServer(port_engine(tiny, tiny.pp, ONLINE_RT, tp), **dict(KW, **kw))
    handle = server.start_online(max_queue=max_queue)
    results = []
    try:
        if handle.leader:
            results = [handle.submit(dict(r)).result(timeout=WAIT) for r in requests]
        else:
            with pytest.raises(RuntimeError, match="submit to rank 0"):
                handle.submit(dict(requests[0]))
    finally:
        handle.close(timeout=WAIT)
    assert not handle._thread.is_alive() and handle.error is None
    return results, server


def test_online_tp_matches_jax_and_tp1_stats(tiny, videos):
    """A keyed sequence through both caches (vision 1 slot, prefix 2):
    captures, hits, an LRU eviction, a pixel-less question, a request
    pinned to features of a key only the prefix cache still holds, an
    expired deadline and a malformed request. Rank 0's tokens are the JAX
    tp = 2 streams; both ranks' ``stats`` and cache keys are the tp = 1
    online server's."""
    q, grid, want = videos
    (a1, pa), (a2, _), (b1, pb) = q["a1"], q["a2"], q["b1"]
    seq = [_req(a1, pa, grid, video_key="A"), _req(a2, pa, grid, video_key="A"),
           _req(b1, pb, grid, video_key="B"), _req(a2, video_key="A"),
           _req(a1, deadline_s=0.0), {"input_ids": "not-an-array"},
           _req(b1, pb, grid, video_key="B")]
    names = ["a1", "a2", "b1", "a2", None, None, "b1"]
    kw = dict(vision_cache_slots=1, prefix_cache_slots=2)
    one, srv1 = _serve_online(tiny, seq, **kw)

    def rank(tp):
        res, server = _serve_online(tiny, seq, tp, **kw)
        return res, server.stats, list(server._vision_cache), list(server._prefix_cache)

    (r0, stats0, vc0, pc0), (r1, stats1, vc1, pc1) = run_ranks(rank)
    assert r1 == []
    for got, o, name in zip(r0, one, names):
        assert got.cancelled == o.cancelled and bool(got.error) == bool(o.error)
        np.testing.assert_array_equal(got.tokens, o.tokens)
        if name is not None:
            np.testing.assert_array_equal(got.tokens, want[name])
    assert stats0 == stats1 == srv1.stats
    assert vc0 == vc1 == list(srv1._vision_cache) and pc0 == pc1 == list(srv1._prefix_cache)
    assert srv1.stats["prefix_cache_hits"] >= 3 and srv1.stats["requests_failed"] == 1
    assert srv1.stats["requests_rejected_deadline"] == 1


def test_online_tp_two_threads_staggered(tiny, videos):
    """Six submissions from two threads at staggered times (two slots,
    forced compactions, streaming on rank 0): every stream is the JAX tp = 2
    stream, the streamed chunks concatenate to it, and the follower's
    ``stats`` equal rank 0's."""
    q, grid, want = videos
    order = ["a1", "b1", "a2", "b1", "a2", "a1"]

    def rank(tp):
        server = ContinuousServer(port_engine(tiny, tiny.pp, ONLINE_RT, tp), **KW)
        handle = server.start_online()
        out, chunks = {}, {}
        try:
            if handle.leader:
                def client(idx):
                    futs = []
                    for i in idx:
                        time.sleep(0.05 * i)
                        ids, p = q[order[i]]
                        futs.append((i, handle.submit(
                            _req(ids, p, grid),
                            on_tokens=lambda rid, t, i=i: chunks.setdefault(i, []).extend(t))))
                    for i, f in futs:
                        out[i] = f.result(timeout=WAIT)
                threads = [threading.Thread(target=client, args=(idx,))
                           for idx in ([0, 2, 4], [1, 3, 5])]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(WAIT)
                assert not any(t.is_alive() for t in threads)
        finally:
            handle.close(timeout=WAIT)
        assert not handle._thread.is_alive() and handle.error is None
        return out, chunks, server.stats

    (out, chunks, stats0), (_, _, stats1) = run_ranks(rank)
    assert len(out) == len(order)
    for i, name in enumerate(order):
        np.testing.assert_array_equal(out[i].tokens, want[name])
        np.testing.assert_array_equal(np.asarray(chunks[i]), want[name])
    assert stats0 == stats1 and stats0["compactions"] >= 1
    assert stats0["requests_finished"] == len(order)


def test_online_tp_features_evicted_before_admission_travel(tiny, videos):
    """The HTTP front end's race, made deterministic: rank 0 peeks A's
    cached features, a request about B evicts A (one vision slot), then a
    request pinned to the peeked features under key A is admitted: they
    travel as tensors and rank 1 serves the JAX stream. Features whose key
    is still cached (A again, after that admission) do not travel: every
    rank takes its own entry."""
    q, grid, want = videos
    (a2, pa), (b1, pb) = q["a2"], q["b1"]

    def rank(tp):
        server = ContinuousServer(port_engine(tiny, tiny.pp, ONLINE_RT, tp),
                                  **dict(KW, vision_cache_slots=1))
        handle = server.start_online()
        res, sent, peeked = [], [], None
        try:
            if handle.leader:
                for step in range(4):
                    if step == 0:
                        r = _req(a2, pa, grid, video_key="A")
                    elif step == 1:
                        peeked = server._vision_cache["A"]  # the HTTP thread's peek
                        r = _req(b1, pb, grid, video_key="B")
                    elif step == 2:
                        r = _req(a2, video_features=peeked, video_key="A")
                    else:
                        # the pinned features re-entered the cache under A
                        r = _req(a2, video_features=server._vision_cache["A"], video_key="A")
                    before = tp.bytes_broadcast  # read once the send is done
                    res.append(handle.submit(r).result(timeout=WAIT))
                    sent.append(tp.bytes_broadcast - before)
        finally:
            handle.close(timeout=WAIT)
        assert not handle._thread.is_alive() and handle.error is None
        return res, sent, peeked, server.stats, tp.bytes_broadcast

    (res, sent, peeked, stats0, bytes0), (_, _, _, stats1, bytes1) = run_ranks(rank)
    assert [list(r.tokens) for r in res] == [list(want["a2"]), list(want["b1"]),
                                             list(want["a2"]), list(want["a2"])]
    feats_bytes = peeked.embeds.numel() * peeked.embeds.element_size()
    assert sent[2] > feats_bytes > sent[3]  # evicted: the features travel; cached: not
    assert bytes0 == bytes1 == sum(sent)
    assert stats0 == stats1 and stats0["vision_cache_hits"] == 2


def test_online_tp_deadline_max_queue_and_admission_error(tiny, videos):
    """One slot: while a request decodes, a queued request whose deadline
    passed is rejected without a prefill on both ranks, a submission past
    ``max_queue`` raises ``queue.Full`` on rank 0, and a malformed request
    fails alone on both ranks (the next one still serves its JAX stream)."""
    q, grid, want = videos
    (a1, pa), (b1, pb) = q["a1"], q["b1"]

    def rank(tp):
        server = ContinuousServer(port_engine(tiny, tiny.pp, ONLINE_RT, tp),
                                  **dict(KW, batch_slots=1, segment_steps=2, gap_capacity=64))
        handle = server.start_online(max_queue=1)
        res = {}
        try:
            if handle.leader:
                admitted = threading.Event()
                f0 = handle.submit(_req(a1, pa, grid), on_tokens=lambda rid, t: admitted.set())
                assert admitted.wait(timeout=WAIT)
                f1 = handle.submit(_req(b1, pb, grid, deadline_s=0.0))
                with pytest.raises(queue.Full):
                    handle.submit(_req(b1, pb, grid, deadline_s=0.0))
                res["ok"], res["late"] = f0.result(timeout=WAIT), f1.result(timeout=WAIT)
                res["bad"] = handle.submit({"input_ids": "not-an-array"}).result(timeout=WAIT)
                res["next"] = handle.submit(_req(b1, pb, grid)).result(timeout=WAIT)
                with pytest.raises(TypeError, match="cannot travel"):
                    handle.submit(_req(b1, extra=object()))
        finally:
            handle.close(timeout=WAIT)
        assert not handle._thread.is_alive() and handle.error is None
        return res, server.stats

    (res, stats0), (_, stats1) = run_ranks(rank)
    np.testing.assert_array_equal(res["ok"].tokens, want["a1"])
    assert res["late"].cancelled and len(res["late"].tokens) == 0
    assert res["bad"].error and res["bad"].cancelled
    np.testing.assert_array_equal(res["next"].tokens, want["b1"])
    assert stats0 == stats1
    assert (stats0["requests_rejected_deadline"], stats0["requests_failed"],
            stats0["requests_admitted"]) == (1, 1, 2)


def test_online_tp_rank_local_failure_ends_every_worker(tiny, videos):
    """An exception on rank 1 alone, in its prefill: no rank hangs. Each
    worker ends with an exception within the group's timeout, rank 0's
    pending future fails with it, and later submissions raise."""
    q, grid, _ = videos
    a1, pa = q["a1"]
    store = dist.HashStore()

    def make(rank):
        return dist.ProcessGroupGloo(dist.PrefixStore("local", store), rank, 2,
                                     datetime.timedelta(seconds=5))

    results, errors = [None, None], [None, None]

    def body(r):
        try:
            tp = TensorParallel(make(r))
            server = ContinuousServer(port_engine(tiny, tiny.pp, ONLINE_RT, tp), **KW)
            if r == 1:
                def boom(*a, **kw):
                    raise RuntimeError("rank 1 alone")
                server.engine.generate = boom
            handle = server.start_online()
            fut = handle.submit(_req(a1, pa, grid)) if r == 0 else None
            handle._thread.join(WAIT)
            out = {"alive": handle._thread.is_alive(), "error": handle.error}
            if fut is not None:
                out["future"] = fut.exception(timeout=WAIT)
                with pytest.raises(RuntimeError):
                    handle.submit(_req(a1, pa, grid))
            results[r] = out
        except BaseException as e:  # handed to the test thread below
            errors[r] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=body, args=(r,), daemon=True) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads) and errors == [None, None], errors
    for out in results:
        assert not out["alive"] and out["error"] is not None
    assert results[0]["future"] is results[0]["error"]
    assert time.perf_counter() - t0 < WAIT


# ---------------------------------------------------------------- HTTP


class StubTokenizer:
    def encode(self, s):
        return [20 + (b % 400) for b in s.encode()][:64]

    def decode(self, ids, **kw):
        return " ".join(str(int(i)) for i in ids)


HTTP_RT = {"max_new_tokens": 8, "max_num_frames": 8, "sample_fps": 2,
           "longsize_resolution": 84,
           "longvideo_kwargs": {"chunked_prefill_frames": 2, "frame_chunk_size": 2}}


def _processor(cfg):
    v = cfg.vision
    return Qwen2VLProcessor(
        StubTokenizer(), vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id, video_token_id=cfg.video_token_id,
        patch_size=v.patch_size, merge_size=v.spatial_merge_size,
        temporal_patch_size=v.temporal_patch_size, min_pixels=1)


def test_http_tp_miss_then_prefix_hit_blocking_and_streamed(tiny, tmp_path):
    """``RetakeHTTPServer`` on both ranks (rank 0 binds port 0): /healthz, a
    question about a JPEG frame directory (a miss: frames, ViT and capture
    on rank 0's request, sent to rank 1), the same question again (a prefix
    hit: only the ids travel) blocking and streamed, a request whose
    admission fails on both ranks (500), /metrics. Every answer is the JAX
    tp = 2 engine's stream on the same processor inputs."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(56, 84, 3), dtype=np.uint8)
    for i in range(8):
        Image.fromarray(np.roll(base, i * 5, axis=1)).save(tmp_path / f"{i:06d}.jpg")
    question = "Q one? A. x B. y"
    x = _processor(tiny.cfg)(question, fetch_video(str(tmp_path), 8, 2, 84, extraction_fps=2.0))
    with jax.set_mesh(tiny.mesh):
        want = [int(t) for t in jax_tp_engine(tiny, tiny.jp, HTTP_RT).generate(
            x["input_ids"], x["pixel_values_videos"], x["video_grid_thw"],
            max_new_tokens=8).tokens]
    body = json.dumps({"question": question, "video_path": str(tmp_path),
                       "extraction_fps": 2.0}).encode()

    def post(url, stream=False):
        data = body if not stream else body[:-1] + b', "stream": true}'
        req = urllib.request.Request(url + "/v1/generate", data=data, method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return r.read()

    def rank(tp):
        eng = port_engine(tiny, tiny.pp, HTTP_RT, tp)
        srv = RetakeHTTPServer(eng, _processor(tiny.cfg) if tp.rank == 0 else None, eng.retake,
                               port=0, max_new_tokens=8, prefix_cache_slots=1)
        srv.start()
        out = {}
        try:
            if srv.leader:
                url = f"http://127.0.0.1:{srv.port}"
                with urllib.request.urlopen(url + "/healthz", timeout=WAIT) as r:
                    out["health"] = json.loads(r.read())
                out["miss"] = json.loads(post(url))
                out["hit"] = json.loads(post(url))
                events = [json.loads(ln[6:]) for ln in post(url, stream=True).decode().split("\n\n")
                          if ln.startswith("data: ")]
                out["stream"] = events
                req = urllib.request.Request(  # fails its admission on both ranks: 500
                    url + "/v1/generate", method="POST",
                    data=json.dumps({"question": "Q?", "max_new_tokens": 10**6}).encode())
                with pytest.raises(urllib.error.HTTPError) as err:
                    urllib.request.urlopen(req, timeout=WAIT)
                out["failed"] = (err.value.code, json.loads(err.value.read()))
                with urllib.request.urlopen(url + "/metrics", timeout=WAIT) as r:
                    out["metrics"] = json.loads(r.read())
        finally:
            srv.shutdown(timeout=WAIT)
        assert srv.handle is None
        return out, srv.server.stats, tp.bytes_broadcast

    (out, stats0, bytes0), (_, stats1, bytes1) = run_ranks(rank)
    assert out["health"]["ok"]
    assert out["miss"]["tokens"] == out["hit"]["tokens"] == want
    streamed = [t for e in out["stream"][:-1] for t in e["tokens"]]
    assert streamed == out["stream"][-1]["tokens"] == want and out["stream"][-1]["done"]
    assert stats0 == stats1
    assert (stats0["prefix_cache_misses"], stats0["prefix_cache_hits"]) == (1, 2)
    code, failed = out["failed"]
    assert code == 500 and "exceeds server prefill bucket" in failed["error"]
    assert out["metrics"]["prefix_cache_hits"] == 2 and out["metrics"]["requests_finished"] == 3
    assert out["metrics"]["requests_failed"] == 1
    assert bytes0 == bytes1 > x["pixel_values_videos"].nbytes


# ---------------------------------------------------------------- the broadcasts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64, torch.bool,
                                   torch.uint8, torch.float16])
def test_broadcast_tensor_and_bytes(dtype):
    """``broadcast_tensor`` carries rank 0's dtype, shape and bits (a 0-d
    and an empty tensor too); ``broadcast_bytes`` rank 0's bytes;
    ``bytes_broadcast`` counts the payloads."""
    src = [(torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) * 0.37).to(dtype),
           torch.tensor(3, dtype=torch.float32).to(dtype), torch.zeros((0, 5), dtype=dtype)]

    def rank(tp):
        got = [tp.broadcast_tensor(t if tp.rank == 0 else None) for t in src]
        msg = tp.broadcast_bytes(b"\x00header\xff" if tp.rank == 0 else None)
        return got, msg, tp.bytes_broadcast

    for got, msg, n in run_ranks(rank):
        for g, t in zip(got, src):
            assert g.dtype == t.dtype and g.shape == t.shape and torch.equal(g, t)
        assert msg == b"\x00header\xff"
        assert n == sum(t.numel() * t.element_size() for t in src) + len(msg)
