"""The sequential decode's CUDA-graph path, on the CPU, at tiny shapes with
random weights: which requests take it (``engine._graph_decode_ok``), and
the loop's replay branch run with ``StepGraph`` stood in for by an eager
step over the same static token buffer (``EagerGraph``). A request that
takes the graph serves the eager loop's tokens, calls ``text.final_logits``
(looked up on the module, where the benchmark's logit tap sits) once per
served token, counts its replayed steps in the stage totals
(``decode_graph_steps``) and leaves ``decode.capture`` / ``decode.replay``
spans inside its ``decode.step`` spans. Every other request runs the eager
loop, with no count. The graph itself runs on the card
(``tests/test_torch_decode_graph_gpu.py``).
"""

import datetime
import json
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from portbench import spec
from portbench.trace import Trace
from retake_tpu_torch.models.qwen2_vl import config as qconfig
from retake_tpu_torch.models.qwen2_vl import params as qparams
from retake_tpu_torch.models.qwen2_vl import text
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.parallel.mesh import TensorParallel, shard_params
from retake_tpu_torch.runtime import engine as tengine
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.utils import profiling
from retake_tpu_torch.utils.config import RetakeConfig

TEXT = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=4096,
            rope_theta=10000.0, tie_word_embeddings=False, bos_token_id=0, eos_token_id=1)
LONGVIDEO = {"chunked_prefill_frames": 2, "frame_chunk_size": 2,
             "kvcache_compression": True,
             "kvcache_compression_kwargs": {"compression_ratio": 0.6, "pos_embed_reforge": True}}
N = 7  # tokens a request serves: 6 decode steps, 5 of them replayed


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return qconfig.Qwen2VLConfig(
        **TEXT, mrope_section=(4, 2, 2), vision_start_token_id=3, vision_end_token_id=4,
        image_token_id=5, video_token_id=6,
        vision=qconfig.Qwen2VisionConfig(depth=2, embed_dim=32, hidden_size=64, mlp_ratio=2,
                                         num_heads=2, in_channels=3, patch_size=2,
                                         spatial_merge_size=2, temporal_patch_size=2))


@pytest.fixture(scope="module")
def params(cfg):
    return qparams.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")


def engine(cfg, params, tp=None, **rt):
    rd = dict(dict(longvideo_kwargs=LONGVIDEO, decode_early_stop=False), **rt)
    model = Qwen2VLModel(cfg, shard_params(params, tp) if tp is not None else params, tp)
    return Qwen2VLEngine(cfg, model, RetakeConfig.from_dict(rd), device="cpu", tp=tp)


def request(cfg, seed=0, grid_t=4):
    rng = np.random.default_rng(seed)
    ids = np.array(rng.integers(10, 500, 3).tolist() + [cfg.vision_start_token_id]
                   + [cfg.video_token_id] * (grid_t * 4) + [cfg.vision_end_token_id]
                   + rng.integers(10, 500, 5).tolist(), np.int64)
    patches = rng.normal(size=(grid_t * 16, cfg.vision.patch_input_dim)).astype(np.float32)
    return dict(input_ids=ids, pixel_values_videos=patches,
                video_grid_thw=np.array([[grid_t, 4, 4]]))


def one_rank_tp():
    group = dist.ProcessGroupGloo(dist.HashStore(), 0, 1, datetime.timedelta(seconds=30))
    return TensorParallel(group)


class EagerGraph:
    """``StepGraph`` on the CPU: the capture runs nothing; a replay copies
    the token into the static buffer and runs the step on it eagerly."""

    captures = 0

    def __init__(self, step, token):
        EagerGraph.captures += 1
        self.step, self.token = step, token.clone()

    def replay(self, token):
        self.token.copy_(token)
        return self.step(self.token)


def stub_cuda(monkeypatch):
    """The loop takes its cache for a CUDA one and captures with
    ``EagerGraph``; every other condition of the path choice is the
    engine's own."""
    real = tengine._graph_decode_ok
    cuda_kv = types.SimpleNamespace(k=types.SimpleNamespace(is_cuda=True))
    monkeypatch.setattr(tengine, "_graph_decode_ok", lambda kv, *a: real(cuda_kv, *a))
    monkeypatch.setattr(tengine, "StepGraph", EagerGraph)
    EagerGraph.captures = 0


@pytest.fixture
def as_cuda(monkeypatch):
    stub_cuda(monkeypatch)


def graph_steps(res) -> int:
    return (res.stages or {}).get("decode_graph_steps", 0)


@pytest.mark.parametrize("case,want", [
    ({}, True),
    (dict(steps=tengine.GRAPH_MIN_STEPS), True),
    (dict(cuda=False), False),
    (dict(sampler=object()), False),
    (dict(tp=object()), False),
    (dict(steps=tengine.GRAPH_MIN_STEPS - 1), False),
])
def test_graph_decode_ok(case, want):
    """Each condition alone turns the graph off: a CPU cache, a sampler,
    tensor parallelism, fewer than ``GRAPH_MIN_STEPS`` steps."""
    kv = types.SimpleNamespace(k=types.SimpleNamespace(is_cuda=case.get("cuda", True)))
    model = types.SimpleNamespace(tp=case.get("tp"))
    got = tengine._graph_decode_ok(kv, case.get("sampler"), model, case.get("steps", 31))
    assert got is want


@pytest.fixture(scope="module")
def eager(cfg, params):
    """The eager loop's tokens for requests 0 and 1, and request 0's served
    logits."""
    eng = engine(cfg, params)
    rows = []
    real = text.final_logits
    text.final_logits = lambda *a, **k: rows.append(real(*a, **k)) or rows[-1]
    try:
        res = [eng.generate(**request(cfg, s), max_new_tokens=N) for s in (0, 1)]
    finally:
        text.final_logits = real
    assert graph_steps(res[0]) == 0  # on the CPU the loop never captures
    return [r.tokens for r in res], torch.stack(rows[:N])


def test_replay_branch_serves_the_eager_tokens(cfg, params, eager, as_cuda, monkeypatch):
    """Two requests on one engine: each captures once, replays every decode
    step but its first, and serves the eager loop's tokens and logits;
    ``final_logits`` is looked up on the module and called once a served
    token; the cache is the request's own, advanced once a step."""
    eng = engine(cfg, params)
    rows = []
    real = text.final_logits
    monkeypatch.setattr(text, "final_logits", lambda *a, **k: rows.append(real(*a, **k))
                        or rows[-1])
    for s in (0, 1):
        res = eng.generate(**request(cfg, s), max_new_tokens=N)
        np.testing.assert_array_equal(res.tokens, eager[0][s])
        assert graph_steps(res) == N - 2
        assert len(rows) == N * (s + 1)
        assert int(res.cache.length) == res.cache_fill + N - 1
    assert EagerGraph.captures == 2
    assert torch.equal(torch.stack(rows[:N]), eager[1])


def test_early_stop_on_the_replay_branch(cfg, params, monkeypatch):
    """With early stop the host reads each token one step late between
    replays; the tokens are the eager loop's."""
    def run():
        return engine(cfg, params, decode_early_stop=True).generate(**request(cfg, 2),
                                                                    max_new_tokens=N)

    want = run()
    stub_cuda(monkeypatch)
    got = run()
    assert EagerGraph.captures == 1
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("case", ["sampler", "tp", "spec", "few_steps"])
def test_eager_loop_elsewhere(cfg, params, case, monkeypatch):
    """A sampler, tensor parallelism, speculative decode and fewer than
    ``GRAPH_MIN_STEPS`` decode steps run the eager loop even where the
    cache is on CUDA: no capture, no count, the same tokens."""
    n = tengine.GRAPH_MIN_STEPS if case == "few_steps" else N
    rt = {"sampler": dict(do_sample=True, temperature=1.0, seed=3),
          "spec": dict(spec_decode=True)}.get(case, {})

    def run():
        tp = one_rank_tp() if case == "tp" else None
        return engine(cfg, params, tp=tp, **rt).generate(**request(cfg, 0), max_new_tokens=n)

    want = run()
    stub_cuda(monkeypatch)
    got = run()
    assert EagerGraph.captures == 0 and graph_steps(got) == 0
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_spans_nest_under_the_profiler(cfg, params, as_cuda, tmp_path):
    """Under ``torch.profiler``: one ``decode.step`` a decode step, the
    capture inside the second, a ``decode.replay`` inside each step from the
    second on; ``decode.graph_share`` reads the replayed share."""
    eng = engine(cfg, params)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.generate(**request(cfg, 0), max_new_tokens=N)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]

    def of(name):
        return sorted((e for e in events if e.get("name") == profiling.PREFIX + name),
                      key=lambda e: e["ts"])

    def inside(inner, outer):
        return outer["ts"] <= inner["ts"] and (inner["ts"] + inner["dur"]
                                               <= outer["ts"] + outer["dur"])

    steps, (capture,), replays = of("decode.step"), of("decode.capture"), of("decode.replay")
    assert len(steps) == N - 1 and len(replays) == N - 2
    assert inside(capture, steps[1]) and not inside(capture, steps[0])
    assert all(inside(r, s) for r, s in zip(replays, steps[1:]))
    (decode,) = of("decode")
    assert all(inside(s, decode) for s in steps)
    run = types.SimpleNamespace(profiles={"request": Trace(events, 1.0)})
    assert spec.metric_reader("decode.graph_share")(run) == pytest.approx((N - 2) / (N - 1))
