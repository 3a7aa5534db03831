"""The port's HTTP front end (``retake_tpu_torch/runtime/http_server.py``)
end to end through a real socket on the tiny fp32 model, frames loaded from
a JPEG frame directory: the ports of tests/test_http.py (vision cache,
prefix cache, metrics, 503 on a full backlog; generate and stream stays
``slow`` as there). Every answer's tokens equal the JAX engine's
``generate`` on the same processor inputs. The server binds port 0 and
every client call carries a timeout.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu.runtime.engine import Qwen2VLEngine as JaxEngine
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.data.processor import Qwen2VLProcessor
from retake_tpu_torch.data.video import fetch_video
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.runtime.http_server import RetakeHTTPServer
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import port_cfg, port_params, tiny_cfg

TIMEOUT = 300
Q1, Q2 = "Q one? A. x B. y", "Q two? A. p B. q"


def rt_dict(max_new):
    return {"max_new_tokens": max_new, "max_num_frames": 8, "sample_fps": 2,
            "longsize_resolution": 84,
            "longvideo_kwargs": {"chunked_prefill_frames": 2, "frame_chunk_size": 2}}


class StubTokenizer:
    def encode(self, s):
        return [20 + (b % 400) for b in s.encode()][:64]

    def decode(self, ids, **kw):
        return " ".join(str(int(i)) for i in ids)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg()
    jp = jparams.init_params(cfg, seed=0, dtype=jnp.float32)
    return cfg, jp, Qwen2VLModel(port_cfg(cfg), port_params(jp))


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("http_video")
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(56, 84, 3), dtype=np.uint8)
    for i in range(8):
        Image.fromarray(np.roll(base, i * 5, axis=1)).save(root / f"{i:06d}.jpg")
    return str(root)


def _processor(cfg):
    v = cfg.vision
    return Qwen2VLProcessor(
        StubTokenizer(), vision_start_token_id=cfg.vision_start_token_id,
        vision_end_token_id=cfg.vision_end_token_id, video_token_id=cfg.video_token_id,
        patch_size=v.patch_size, merge_size=v.spatial_merge_size,
        temporal_patch_size=v.temporal_patch_size, min_pixels=1,
    )


@pytest.fixture(scope="module")
def expected(tiny, frame_dir):
    """The JAX engine's tokens for Q1 and Q2 about the frame directory (at
    extraction fps 2 and 1), from the port processor's inputs, at 24 new
    tokens (greedy streams are prefix-stable)."""
    cfg, jp, _ = tiny
    jeng = JaxEngine(cfg, jp, JaxRetakeConfig.from_dict(rt_dict(24)))
    proc = _processor(cfg)
    out = {}
    for fps in (2.0, 1.0):
        frames = fetch_video(frame_dir, 8, 2, 84, extraction_fps=fps)
        for q in (Q1, Q2):
            x = proc(q, frames)
            out[q, fps] = [int(t) for t in jeng.generate(
                x["input_ids"], x["pixel_values_videos"], x["video_grid_thw"],
                max_new_tokens=24).tokens]
    return out


def _server(tiny, max_new, **kw):
    cfg, _, model = tiny
    rt = RetakeConfig.from_dict(rt_dict(max_new))
    engine = Qwen2VLEngine(port_cfg(cfg), model, rt, device="cpu")
    return RetakeHTTPServer(engine, _processor(cfg), rt, port=0, max_new_tokens=max_new, **kw)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=TIMEOUT)


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _counting_encode(monkeypatch):
    n = {"encode": 0}
    orig = Qwen2VLEngine.encode_video

    def counting(self, *a, **kw):
        n["encode"] += 1
        return orig(self, *a, **kw)

    monkeypatch.setattr(Qwen2VLEngine, "encode_video", counting)
    return n


@pytest.mark.slow
def test_http_generate_and_stream(tiny, frame_dir, expected):
    """healthz, a blocking generate, the same question streamed (the chunks
    concatenate to the done event's tokens), a 400 on a bad body."""
    with _server(tiny, 8, batch_slots=2, segment_steps=3, gap_capacity=64) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        h = _get(base + "/healthz")
        assert h["ok"] and h["batch_slots"] == 2
        body = {"question": Q1, "video_path": frame_dir, "extraction_fps": 2}
        with _post(base + "/v1/generate", body) as r:
            out = json.loads(r.read())
        assert out["tokens"] == expected[Q1, 2.0][:8]
        assert not out["cancelled"] and out["latency_s"] >= out["ttft_s"]
        with _post(base + "/v1/generate", dict(body, stream=True)) as r:
            assert r.headers["Content-Type"].startswith("text/event-stream")
            events = [json.loads(line[len(b"data: "):]) for line in r.read().split(b"\n\n")
                      if line.startswith(b"data: ")]
        streamed = [t for e in events if not e.get("done") for t in e["tokens"]]
        assert streamed == events[-1]["tokens"] == expected[Q1, 2.0][:8]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/v1/generate", {"video_path": frame_dir})
        assert e.value.code == 400
        assert _get(base + "/healthz")["ok"]


def test_http_vision_cache(tiny, frame_dir, expected, monkeypatch):
    """A second question about the same video_path skips frame loading and
    the encode; another extraction_fps is another key and encodes anew."""
    n = _counting_encode(monkeypatch)
    with _server(tiny, 6, batch_slots=2, segment_steps=3, gap_capacity=64,
                 vision_cache_slots=1) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        body = {"question": Q1, "video_path": frame_dir, "extraction_fps": 2}
        with _post(base + "/v1/generate", body) as r:
            out1 = json.loads(r.read())
        with _post(base + "/v1/generate", dict(body, question=Q2)) as r:
            out2 = json.loads(r.read())
        assert n["encode"] == 1
        with _post(base + "/v1/generate", dict(body, extraction_fps=1)) as r:
            out3 = json.loads(r.read())
        assert n["encode"] == 2
    assert out1["tokens"] == expected[Q1, 2.0][:6]
    assert out2["tokens"] == expected[Q2, 2.0][:6]
    assert out3["tokens"] == expected[Q1, 1.0][:6]


def test_http_prefix_cache(tiny, frame_dir, expected, monkeypatch):
    """A re-ask of the same video_path is a prefix hit: no frame loading, no
    encode, no video prefill; the metrics count one miss, two hits."""
    n = _counting_encode(monkeypatch)
    with _server(tiny, 6, batch_slots=2, segment_steps=3, gap_capacity=64,
                 prefix_cache_slots=1) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        body = {"question": Q1, "video_path": frame_dir, "extraction_fps": 2}
        outs = []
        for q in (Q1, Q1, Q2):
            with _post(base + "/v1/generate", dict(body, question=q)) as r:
                outs.append(json.loads(r.read()))
        m = _get(base + "/metrics")
    assert n["encode"] == 1
    assert [o["tokens"] for o in outs] == [expected[q, 2.0][:6] for q in (Q1, Q1, Q2)]
    assert (m["prefix_cache_misses"], m["prefix_cache_hits"], m["prefix_cache_entries"]) == (1, 2, 1)


def test_http_metrics(tiny, frame_dir, expected):
    """GET /metrics: the server's stats key by key, the cache entries, the
    uptime."""
    with _server(tiny, 6, batch_slots=2, segment_steps=3, gap_capacity=64,
                 vision_cache_slots=1) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        body = {"question": Q1, "video_path": frame_dir, "extraction_fps": 2}
        for _ in range(2):
            with _post(base + "/v1/generate", body) as r:
                assert json.loads(r.read())["tokens"] == expected[Q1, 2.0][:6]
        m = _get(base + "/metrics")
        stats = dict(srv.server.stats)
    assert {k: m[k] for k in stats} == stats
    assert m["requests_admitted"] == m["requests_finished"] == 2
    assert m["requests_cancelled"] == m["requests_failed"] == 0
    assert m["tokens_emitted"] == 12
    assert (m["vision_cache_misses"], m["vision_cache_hits"], m["vision_cache_entries"]) == (1, 1, 1)
    assert m["segments_dispatched"] >= 1 and m["uptime_s"] >= 0


def test_http_503_on_full_backlog(tiny, frame_dir, expected):
    """With max_queue 1 and the one slot busy, a queued request fills the
    backlog and the next POST gets 503 with Retry-After; both earlier
    requests complete with their JAX tokens."""
    with _server(tiny, 24, max_queue=1, batch_slots=1, segment_steps=2,
                 gap_capacity=64) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        body = {"question": Q1, "video_path": frame_dir, "extraction_fps": 2}
        r1 = _post(base + "/v1/generate", dict(body, stream=True))
        assert r1.readline().startswith(b"data: ")  # admitted: the backlog is empty
        results = {}

        def post2():
            with _post(base + "/v1/generate", body) as r:
                results["r2"] = json.loads(r.read())

        t2 = threading.Thread(target=post2)
        t2.start()
        for _ in range(2000):
            if srv.handle._q.qsize() >= 1:
                break
            time.sleep(0.01)
        assert srv.handle._q.qsize() >= 1
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/v1/generate", body)
        assert e.value.code == 503 and e.value.headers["Retry-After"]
        events = [json.loads(line[len(b"data: "):]) for line in r1.read().split(b"\n\n")
                  if line.startswith(b"data: ")]
        r1.close()
        t2.join(timeout=TIMEOUT)
        assert not t2.is_alive()
    assert events[-1]["done"] and events[-1]["tokens"] == expected[Q1, 2.0]
    assert results["r2"]["tokens"] == expected[Q1, 2.0]


def test_http_failed_admission_is_500(tiny):
    """A request the processor accepts but the server cannot admit (a
    budget beyond the server's bucket) answers 500 with the error; the
    server keeps serving."""
    with _server(tiny, 4, batch_slots=1, segment_steps=2, gap_capacity=64) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        with _post(base + "/v1/generate", {"question": Q1}) as r:  # sizes the bucket
            first = json.loads(r.read())["tokens"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/v1/generate", {"question": Q1, "max_new_tokens": 100000})
        err = json.loads(e.value.read())
        assert e.value.code == 500 and "exceeds server prefill bucket" in err["error"]
        assert err["cancelled"] and err["tokens"] == []
        with _post(base + "/v1/generate", {"question": Q1}) as r:
            assert json.loads(r.read())["tokens"] == first
        assert srv.server.stats["requests_failed"] == 1
    assert len(first) == 4
