"""The port's spans and stage timer (``retake_tpu_torch/utils/profiling.py``)
on the CPU, at tiny shapes with random weights: the off path never enters
``record_function`` and stays under 1 us a span; under ``torch.profiler``
the engines and the serving loop leave ``retake::`` ranges of the documented
names, nested by cause, which ``portbench.trace.Trace`` reads as host events;
``StageTimer`` times stages without a device fence.
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.trace import Trace
from retake_tpu_torch.models.llava_onevision import config as lconfig
from retake_tpu_torch.models.llava_onevision import params as lparams
from retake_tpu_torch.models.llava_onevision.model import LlavaOnevisionModel
from retake_tpu_torch.models.qwen2_vl import config as qconfig
from retake_tpu_torch.models.qwen2_vl import params as qparams
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.runtime.llava_engine import LlavaOnevisionEngine
from retake_tpu_torch.runtime.serve import ContinuousServer
from retake_tpu_torch.utils import profiling
from retake_tpu_torch.utils.config import RetakeConfig

TEXT = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=4096,
            rope_theta=10000.0, tie_word_embeddings=False, bos_token_id=0, eos_token_id=1)
# chunked prefill, ViT / SigLIP in chunks, DPSelect's keyframe mask, PivotKV
RT = {"longvideo_kwargs": {
    "chunked_prefill_frames": 2, "frame_chunk_size": 2, "visual_compression": True,
    "visual_compression_kwargs": {"compression_ratio": 1.0, "compression_method": "Keyframe",
                                  "return_keyframe_mask": True},
    "kvcache_compression": True,
    "kvcache_compression_kwargs": {"compression_ratio": 0.6, "pos_embed_reforge": True},
}}
ENGINE_SPANS = {"request", "vision", "vision.chunk", "dpselect", "plan", "prefill.chunk",
                "first_token", "decode.step", "decoder.rope", "decoder.qkv", "decoder.attn",
                "decoder.mlp", "decoder.cache", "decoder.evict"}
SERVE_SPANS = {"serve.wait", "serve.admit", "serve.segment", "serve.harvest", "serve.compact",
               "decoder.rope", "decoder.qkv", "decoder.attn", "decoder.mlp"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny shapes gain nothing from more, and the
    parallel suite's workers would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qwen():
    cfg = qconfig.Qwen2VLConfig(
        **TEXT, mrope_section=(4, 2, 2), vision_start_token_id=3, vision_end_token_id=4,
        image_token_id=5, video_token_id=6,
        vision=qconfig.Qwen2VisionConfig(depth=2, embed_dim=32, hidden_size=64, mlp_ratio=2,
                                         num_heads=2, in_channels=3, patch_size=2,
                                         spatial_merge_size=2, temporal_patch_size=2))
    model = Qwen2VLModel(cfg, qparams.init_params(cfg, seed=0, dtype=torch.float32,
                                                  device="cpu"))
    return Qwen2VLEngine(cfg, model, RetakeConfig.from_dict(RT), device="cpu")


@pytest.fixture(scope="module")
def llava():
    cfg = lconfig.LlavaOnevisionConfig(
        text=qconfig.Qwen2VLConfig(**TEXT, mrope_section=None),
        vision=lconfig.SiglipVisionConfig(hidden_size=32, intermediate_size=64,
                                          num_hidden_layers=2, num_attention_heads=2,
                                          image_size=16, patch_size=4),
        image_token_id=5, video_token_id=6)
    model = LlavaOnevisionModel(cfg, lparams.init_params(cfg, seed=0, dtype=torch.float32,
                                                         device="cpu"))
    return LlavaOnevisionEngine(cfg, model, RetakeConfig.from_dict(RT), device="cpu")


def qwen_request(cfg, seed, grid_t=4, prompt_len=5):
    rng = np.random.default_rng(seed)
    n_vid = grid_t * 4 * 4 // 4
    ids = np.array(rng.integers(10, 500, 3).tolist() + [cfg.vision_start_token_id]
                   + [cfg.video_token_id] * n_vid + [cfg.vision_end_token_id]
                   + rng.integers(10, 500, prompt_len).tolist(), np.int64)
    patches = rng.normal(size=(grid_t * 16, cfg.vision.patch_input_dim)).astype(np.float32)
    return dict(input_ids=ids, pixel_values_videos=patches,
                video_grid_thw=np.array([[grid_t, 4, 4]]))


def llava_request(cfg, seed, frames=4):
    rng = np.random.default_rng(seed)
    ids = np.array(rng.integers(10, 500, 4).tolist()
                   + [cfg.video_token_id] * (frames * cfg.tokens_per_frame + 1)
                   + rng.integers(10, 500, 6).tolist(), np.int64)
    s = cfg.vision.image_size
    vid = rng.integers(0, 255, size=(frames, s, s, 3), dtype=np.uint8)
    return dict(input_ids=ids, pixel_values_videos=vid)


def traced(fn, tmp_path):
    """``fn()`` under the profiler (CPU activity); its value and the Chrome
    trace's ``retake::`` events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [e for e in events if e.get("name", "").startswith(profiling.PREFIX)], events, wall


def names(events):
    return {e["name"][len(profiling.PREFIX):] for e in events}


def inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def of(events, name):
    return [e for e in events if e["name"] == profiling.PREFIX + name]


def server(qwen):
    return ContinuousServer(qwen, batch_slots=2, segment_steps=2, max_new_tokens=24,
                            gap_capacity=8, interleave_prefill=True)


@pytest.fixture(scope="module")
def staggered(qwen):
    """``serve()``: three requests through an interleaving server. The first
    ends before the other two arrive together, so the server waits idle
    between them, and the third's admission runs blind segments for the
    second; they arrive at five times the first's time alone (this host's
    pace)."""
    first = dict(qwen_request(qwen.cfg, 1), max_new_tokens=3)
    t0 = time.perf_counter()
    server(qwen).run([first])
    later = 0.2 + 5 * (time.perf_counter() - t0)
    reqs = [first, qwen_request(qwen.cfg, 2), qwen_request(qwen.cfg, 5, grid_t=8)]
    return lambda: server(qwen).run(reqs, [0.0, later, later])


def test_off_path_never_enters_record_function(qwen, staggered, monkeypatch):
    """No profiler recording: neither ``generate`` nor the serving loop opens
    a range (``record_function`` raises if called)."""

    def boom(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    res = qwen.generate(**qwen_request(qwen.cfg, 0), max_new_tokens=4)
    assert len(res.tokens) >= 1
    out = staggered()
    assert all(len(r.tokens) for r in out)


def test_off_cost_under_a_microsecond():
    """One span with the profiler off, over 10^4 spans (five attrs, as a
    prefill step has): at most 1 us of this thread's CPU time (the best of
    20 passes, so a parallel suite's descheduling does not count)."""
    n = 10_000
    best = float("inf")
    for _ in range(20):
        t0 = time.thread_time()
        for i in range(n):
            with profiling.span("prefill.chunk", chunk=i, kind="video", valid=9, keep=5,
                                cache_len=i):
                pass
        best = min(best, (time.thread_time() - t0) / n)
    print(f"span off cost: {best * 1e6:.3f} us")
    assert best < 1e-6


@pytest.mark.parametrize("family", ["qwen", "llava"])
def test_generate_spans_under_the_profiler(qwen, llava, family, tmp_path):
    """A traced ``generate`` leaves every engine span as a ``user_annotation``,
    nested: ``request`` around all, ``vision`` around its chunks, each
    ``prefill.chunk`` inside ``prefill_chunks``; ``Trace`` reads them."""
    eng = qwen if family == "qwen" else llava
    req = (qwen_request if family == "qwen" else llava_request)(eng.cfg, 3)
    res, ev, raw, wall = traced(lambda: eng.generate(**req, max_new_tokens=4), tmp_path)
    want = ENGINE_SPANS | ({"projector_pool"} if family == "llava" else set())
    assert want <= names(ev), names(ev)
    assert {e["cat"] for e in ev} == {"user_annotation"}
    (request,) = of(ev, "request")
    assert all(inside(e, request) for e in ev)
    (vision,) = of(ev, "vision")
    chunks = of(ev, "vision.chunk")
    assert len(chunks) == 2 and all(inside(c, vision) for c in chunks)
    (prefill,) = of(ev, "prefill_chunks")
    steps = of(ev, "prefill.chunk")
    assert len(steps) >= 2 and all(inside(s, prefill) for s in steps)
    assert len(of(ev, "decode.step")) == len(res.tokens) - 1
    host = {h[0] for h in Trace(raw, wall).host}
    assert {profiling.PREFIX + n for n in want} <= host


def test_spec_decode_is_one_span(qwen, tmp_path):
    """Speculative decode: one ``decode.spec`` span inside ``decode``, no
    ``decode.step``."""
    eng = Qwen2VLEngine(qwen.cfg, qwen.model, RetakeConfig.from_dict(dict(RT, spec_decode=True)),
                        device="cpu")
    _, ev, _, _ = traced(lambda: eng.generate(**qwen_request(eng.cfg, 6), max_new_tokens=6),
                         tmp_path)
    (spec,) = of(ev, "decode.spec")
    (decode,) = of(ev, "decode")
    assert inside(spec, decode) and not of(ev, "decode.step")


def test_serve_spans_nest_by_cause(staggered, tmp_path):
    """A staggered ``run`` with ``interleave_prefill``: a ``serve.wait``
    between the first request and the next, each ``serve.admit`` around its
    engine's ``request`` and ``prefill.chunk`` spans, the third's around
    blind ``serve.segment`` s; ``Trace`` reads them as host events."""
    out, ev, raw, wall = traced(staggered, tmp_path)
    assert all(len(r.tokens) for r in out)
    assert not SERVE_SPANS - names(ev), SERVE_SPANS - names(ev)
    admits = sorted(of(ev, "serve.admit"), key=lambda e: e["ts"])
    assert len(admits) == 3
    for adm in admits:
        assert any(inside(c, adm) for c in of(ev, "prefill.chunk"))
        assert any(inside(r, adm) for r in of(ev, "request"))
    assert any(inside(s, admits[2]) for s in of(ev, "serve.segment"))  # blind segments
    end0 = admits[0]["ts"] + admits[0]["dur"]
    assert any(w["ts"] >= end0 and w["ts"] + w["dur"] <= admits[1]["ts"]
               for w in of(ev, "serve.wait"))
    host = {h[0] for h in Trace(raw, wall).host}
    assert {profiling.PREFIX + n for n in SERVE_SPANS} <= host


def test_stage_timer_never_fences(qwen, monkeypatch):
    """RETAKE_PROFILE=1: no ``torch.cuda.synchronize``; ``stages`` keeps its
    keys, each positive."""

    def fence():
        raise AssertionError("the stage timer fenced the device")

    monkeypatch.setattr(torch.cuda, "synchronize", fence)
    monkeypatch.setenv("RETAKE_PROFILE", "1")
    res = qwen.generate(**qwen_request(qwen.cfg, 4), max_new_tokens=4)
    keys = {"vision_tower", "dpselect", "prefill_chunks", "first_token", "decode"}
    assert set(res.stages) == keys
    assert all(v > 0 for v in res.stages.values())


class FakeEvent:
    """A CUDA event on a clock the test advances (``now``, ms) that counts
    its synchronizes."""

    now = synced = 0

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self, stream=None):
        self.t = FakeEvent.now

    def synchronize(self):
        FakeEvent.synced += 1

    def elapsed_time(self, end):
        return end.t - self.t


def test_stage_timer_on_cuda_waits_on_its_last_event_once(monkeypatch):
    """On a CUDA device the stages are event pairs; reading ``totals`` waits
    on the last end event once and resolves every pending stage."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("fenced"))
    FakeEvent.now = FakeEvent.synced = 0
    timer = profiling.StageTimer(enabled=True, device="cuda")
    for key, ms in (("vision_tower", 2), ("prefill_chunks", 3), ("prefill_chunks", 4)):
        with timer.stage("stage", key):
            FakeEvent.now += ms
        FakeEvent.now += 100  # between stages: not timed
    assert FakeEvent.synced == 0  # nothing waits at a stage boundary
    totals = timer.totals
    assert FakeEvent.synced == 1
    assert dict(totals) == pytest.approx({"vision_tower": 0.002, "prefill_chunks": 0.007})
    timer.totals
    assert FakeEvent.synced == 1  # resolved once
