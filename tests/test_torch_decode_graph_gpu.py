"""The sequential decode's CUDA graph on the card: a request that replays
its decode steps from the graph serves the eager loop's tokens and, bit
for bit, its logits, over small Qwen2-VL (M-RoPE, position reforge) and
LLaVA (1-D RoPE) decoders, every attention arm and a bf16 or int8 KV
cache. Each request captures once and replays every decode step but the
first; the cache is the request's own, advanced once a step.

Every test here needs a CUDA device (marker ``gpu``) and skips without one.
Run on the H100 with:

    python -m pytest tests/test_torch_decode_graph_gpu.py -m gpu -q --noconftest
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from retake_tpu_torch.models.llava_onevision import config as lconfig
from retake_tpu_torch.models.llava_onevision import params as lparams
from retake_tpu_torch.models.llava_onevision.model import LlavaOnevisionModel
from retake_tpu_torch.models.qwen2_vl import config as qconfig
from retake_tpu_torch.models.qwen2_vl import params as qparams
from retake_tpu_torch.models.qwen2_vl import text
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.runtime import engine as tengine
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.runtime.llava_engine import LlavaOnevisionEngine
from retake_tpu_torch.utils import profiling
from retake_tpu_torch.utils.config import RetakeConfig

pytestmark = pytest.mark.gpu

# head_dim 64: the kernels' (K1, K2 in the text decoder, K3 in the ViT)
TEXT = dict(vocab_size=1024, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=4096,
            rope_theta=10000.0, tie_word_embeddings=False, bos_token_id=0, eos_token_id=1)
LONGVIDEO = {"chunked_prefill_frames": 2, "frame_chunk_size": 2,
             "kvcache_compression": True,
             "kvcache_compression_kwargs": {"compression_ratio": 0.6, "pos_embed_reforge": True}}
N = 8  # tokens a request serves: 7 decode steps, 6 of them replayed


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def models(cuda):
    qcfg = qconfig.Qwen2VLConfig(
        **TEXT, mrope_section=(16, 8, 8), vision_start_token_id=3, vision_end_token_id=4,
        image_token_id=5, video_token_id=6,
        vision=qconfig.Qwen2VisionConfig(depth=2, embed_dim=128, hidden_size=256, mlp_ratio=2,
                                         num_heads=2, in_channels=3, patch_size=2,
                                         spatial_merge_size=2, temporal_patch_size=2))
    lcfg = lconfig.LlavaOnevisionConfig(
        text=qconfig.Qwen2VLConfig(**TEXT, mrope_section=None),
        vision=lconfig.SiglipVisionConfig(hidden_size=64, intermediate_size=128,
                                          num_hidden_layers=2, num_attention_heads=2,
                                          image_size=16, patch_size=4),
        image_token_id=5, video_token_id=6)
    with torch.no_grad():
        return {
            "qwen": (qcfg, Qwen2VLModel(qcfg, qparams.init_params(qcfg, seed=0, device=cuda))),
            "llava": (lcfg, LlavaOnevisionModel(lcfg, lparams.init_params(lcfg, seed=0,
                                                                          device=cuda))),
        }


def engine(models, family, attn_impl, kv, **rt):
    cfg, model = models[family]
    rd = dict(longvideo_kwargs=LONGVIDEO, decode_early_stop=False, attn_implementation=attn_impl,
              kv_cache_dtype=None if kv == "bf16" else "int8", **rt)
    cls = Qwen2VLEngine if family == "qwen" else LlavaOnevisionEngine
    return cls(cfg, model, RetakeConfig.from_dict(rd), device="cuda")


def request(family, cfg, seed):
    rng = np.random.default_rng(seed)
    head, tail = rng.integers(10, 1000, 3).tolist(), rng.integers(10, 1000, 5).tolist()
    if family == "qwen":
        grid_t = 4
        ids = (head + [cfg.vision_start_token_id] + [cfg.video_token_id] * (grid_t * 4)
               + [cfg.vision_end_token_id] + tail)
        patches = rng.normal(size=(grid_t * 16, cfg.vision.patch_input_dim)).astype(np.float32)
        return dict(input_ids=np.array(ids, np.int64), pixel_values_videos=patches,
                    video_grid_thw=np.array([[grid_t, 4, 4]]))
    frames, s = 4, cfg.vision.image_size
    ids = head + [cfg.video_token_id] * (frames * cfg.tokens_per_frame + 1) + tail
    video = rng.integers(0, 255, size=(frames, s, s, 3), dtype=np.uint8)
    return dict(input_ids=np.array(ids, np.int64), pixel_values_videos=video)


def served(eng, req, monkeypatch, graph: bool):
    """(result, the logits of every served token), with the graph path
    switched off for the eager loop."""
    rows = []
    real = text.final_logits
    with monkeypatch.context() as m:
        m.setattr(text, "final_logits", lambda *a, **k: rows.append(real(*a, **k)) or rows[-1])
        if not graph:
            m.setattr(tengine, "_graph_decode_ok", lambda *a: False)
        with torch.no_grad():
            res = eng.generate(**req, max_new_tokens=N)
    torch.cuda.synchronize()
    return res, torch.stack(rows)


CASES = [("qwen", "pallas", "bf16"), ("qwen", "flash", "bf16"), ("qwen", "xla", "bf16"),
         ("qwen", "pallas", "int8"), ("qwen", "xla", "int8"),
         ("llava", "pallas", "bf16"), ("llava", "flash", "int8"), ("llava", "xla", "bf16")]


@pytest.mark.parametrize("family,attn_impl,kv", CASES)
def test_graph_replays_the_eager_loop_bit_for_bit(models, family, attn_impl, kv, monkeypatch):
    eng = engine(models, family, attn_impl, kv)
    cfg = models[family][0]
    for seed in (0, 1):  # a graph a request, on one engine
        req = request(family, cfg, seed)
        want, want_logits = served(eng, req, monkeypatch, graph=False)
        got, got_logits = served(eng, req, monkeypatch, graph=True)
        assert (want.stages or {}).get("decode_graph_steps", 0) == 0
        assert got.stages["decode_graph_steps"] == N - 2  # the decode steps less one
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert got_logits.shape[0] == N
        assert torch.equal(got_logits, want_logits)
        assert int(got.cache.length) == got.cache_fill + N - 1
        assert torch.equal(got.cache.k, want.cache.k) and torch.equal(got.cache.pos, want.cache.pos)


def test_sampled_decode_stays_eager(models, monkeypatch):
    eng = engine(models, "qwen", "pallas", "bf16", do_sample=True, temperature=1.0, seed=5)
    res, logits = served(eng, request("qwen", models["qwen"][0], 0), monkeypatch, graph=True)
    assert (res.stages or {}).get("decode_graph_steps", 0) == 0 and logits.shape[0] == N


def test_graph_under_the_profiler(models, monkeypatch, tmp_path):
    """Traced with CUDA activity: the capture and replays leave their spans,
    and the replayed steps' kernels reach the trace (the device busy time
    counts them)."""
    eng = engine(models, "qwen", "pallas", "bf16")
    req = request("qwen", models["qwen"][0], 0)
    counts = {}
    for graph in (False, True):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            served(eng, req, monkeypatch, graph)
        path = tmp_path / f"trace{int(graph)}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        names = [e.get("name") for e in events if e.get("cat") == "user_annotation"]
        counts[graph] = sum(e.get("cat") == "kernel" for e in events)
        replays = names.count(profiling.PREFIX + "decode.replay")
        assert replays == (N - 2 if graph else 0)
        assert names.count(profiling.PREFIX + "decode.capture") == int(graph)
    assert counts[True] >= 0.9 * counts[False], counts
