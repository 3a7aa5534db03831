"""Reuse across questions about one video, port against the JAX engine on
the CPU, fp32, same weights and inputs: ``encode_video`` ->
``generate(video_features=...)`` (tests/test_engine.py
::test_video_features_reuse_matches_inline) and ``encode_prefix`` ->
``generate(prefix=...)`` (the six tests/test_prefix_reuse.py::test_qwen_*
tests, the int8 KV cache included).

Each reused request must give the port's own inline tokens and the JAX
engine's, exactly; where JAX raises, the port raises the same class.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu.runtime import engine as jengine
from retake_tpu.runtime.engine import Qwen2VLEngine as JaxEngine
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.runtime import engine as tengine
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import port_cfg, port_params, tiny_cfg, video_request


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg()
    jp = jparams.init_params(cfg, seed=0, dtype=jnp.float32)
    return cfg, jp, Qwen2VLModel(port_cfg(cfg), port_params(jp))


def _engines(tiny, rd):
    cfg, jp, model = tiny
    return (JaxEngine(cfg, jp, JaxRetakeConfig.from_dict(rd)),
            Qwen2VLEngine(port_cfg(cfg), model, RetakeConfig.from_dict(rd), device="cpu"))


# ---------------------------------------------------------------- video features


@pytest.mark.parametrize("vc_kwargs", [
    {"compression_ratio": 1.0, "return_keyframe_mask": True},  # mask only (shipped configs)
    {"compression_ratio": 0.5, "return_keyframe_mask": True},  # frames dropped: ids reforged
])
def test_video_features_reuse_matches_inline(tiny, vc_kwargs):
    """Two questions about one video through one ``encode_video``."""
    cfg = tiny[0]
    rd = {"longvideo_kwargs": {
        "chunked_prefill_frames": 2, "frame_chunk_size": 2,
        "kvcache_compression": True,
        "kvcache_compression_kwargs": {"compression_ratio": 0.6, "pos_embed_reforge": True},
        "visual_compression": True, "visual_compression_kwargs": vc_kwargs,
    }}
    jeng, teng = _engines(tiny, rd)
    rng = np.random.default_rng(0)
    ids1, patches, grid = video_request(cfg, rng, grid_t=4, prompt_len=5)
    vend = int(np.where(ids1 == cfg.video_token_id)[0][-1]) + 2
    ids2 = np.concatenate([ids1[:vend], rng.integers(10, 500, size=8)]).astype(np.int64)
    feats = teng.encode_video(patches, grid)
    jfeats = jeng.encode_video(patches, grid)
    for ids in (ids1, ids2):
        inline = teng.generate(ids, patches, grid, max_new_tokens=6)
        reused = teng.generate(ids, video_features=feats, max_new_tokens=6)
        want = jeng.generate(ids, video_features=jfeats, max_new_tokens=6)
        np.testing.assert_array_equal(reused.tokens, inline.tokens)
        np.testing.assert_array_equal(reused.tokens, want.tokens)
        assert reused.cache_len == inline.cache_len == want.cache_len


# ---------------------------------------------------------------- prefix reuse


def _rt(kv_kwargs, **top):
    """tests/test_prefix_reuse.py's _qwen_rt: DPSelect at ratio 0.5 and
    PivotKV with reforge, chunked."""
    return {**top, "longvideo_kwargs": {
        "frame_chunk_size": 4, "chunked_prefill_frames": 2,
        "visual_compression": True,
        "visual_compression_kwargs": {"compression_ratio": 0.5, "return_keyframe_mask": True},
        "kvcache_compression": True,
        "kvcache_compression_kwargs": {"compression_method": "pivotkv",
                                       "pos_embed_reforge": True, **kv_kwargs},
    }}


def _request(cfg, rng, question, grid_t=4):
    n_vid = grid_t * 16 // cfg.vision.spatial_merge_size**2
    ids = np.array([10, 11, 12, cfg.vision_start_token_id] + [cfg.video_token_id] * n_vid
                   + [cfg.vision_end_token_id] + list(question), dtype=np.int64)
    patches = rng.normal(size=(grid_t * 16, cfg.vision.patch_input_dim)).astype(np.float32)
    return ids, patches, np.array([[grid_t, 4, 4]])


def _check(teng, jeng, prefix, jprefix, ids, patches, grid, max_new=6):
    inline = teng.generate(ids, patches, grid, max_new_tokens=max_new)
    reused = teng.generate(ids, prefix=prefix, max_new_tokens=max_new)
    want = jeng.generate(ids, prefix=jprefix, max_new_tokens=max_new)
    np.testing.assert_array_equal(reused.tokens, inline.tokens)
    np.testing.assert_array_equal(reused.tokens, want.tokens)
    assert reused.cache_len == inline.cache_len == want.cache_len
    assert reused.input_len == inline.input_len
    assert reused.cache_fill == inline.cache_fill


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefix_reuse_token_exact(tiny, kv_dtype):
    """Two questions of different lengths through one ``encode_prefix``,
    DPSelect dropping frames and PivotKV compressing; a second pass over the
    snapshot is unchanged (each use forks the cache). int8: the snapshot
    carries the scale planes and reuse leaves them as captured
    (tests/test_prefix_reuse.py::test_qwen_prefix_reuse_token_exact and
    ::test_qwen_prefix_reuse_int8_kv)."""
    cfg = tiny[0]
    top = {"kv_cache_dtype": "int8"} if kv_dtype == "int8" else {}
    jeng, teng = _engines(tiny, _rt({"compression_ratio": 0.5}, **top))
    rng = np.random.default_rng(7)
    ids1, patches, grid = _request(cfg, rng, [20, 21, 22, 23, 24])
    ids2, _, _ = _request(cfg, rng, [30, 31, 32, 33, 34, 35, 36, 37])
    prefix = teng.encode_prefix(ids1, patches, grid, max_new_tokens=6)
    jprefix = jeng.encode_prefix(ids1, patches, grid, max_new_tokens=6)
    assert prefix.cache.quantized == (kv_dtype == "int8")
    snapshot = {k: v.clone() for k, v in vars(prefix.cache).items() if v is not None}
    assert (prefix.final_len, prefix.budget, prefix.split, prefix.plan_sig[-1][1:]) == (
        jprefix.final_len, jprefix.budget, jprefix.split, jprefix.plan_sig[-1][1:])
    for ids in (ids1, ids2, ids2):
        _check(teng, jeng, prefix, jprefix, ids, patches, grid)
    for k, v in snapshot.items():
        assert torch.equal(getattr(prefix.cache, k), v), k


def test_prefix_from_video_features(tiny):
    """``encode_prefix`` over a precomputed ``VideoFeatures``
    (tests/test_prefix_reuse.py::test_qwen_prefix_from_video_features)."""
    cfg = tiny[0]
    jeng, teng = _engines(tiny, _rt({"compression_ratio": 0.5}))
    ids, patches, grid = _request(cfg, np.random.default_rng(8), [40, 41, 42, 43])
    feats = teng.encode_video(patches, grid[0])
    prefix = teng.encode_prefix(ids, video_features=feats, max_new_tokens=6)
    assert prefix.features is feats
    jfeats = jeng.encode_video(patches, grid[0])
    jprefix = jeng.encode_prefix(ids, video_features=jfeats, max_new_tokens=6)
    _check(teng, jeng, prefix, jprefix, ids, patches, grid)


def test_prefix_mismatch_and_fallback(tiny):
    """A question whose dynamic ratio resolves to other keep lengths, and one
    with another prompt prefix, raise PrefixMismatch in both engines; the
    features fallback gives the inline tokens
    (tests/test_prefix_reuse.py::test_qwen_prefix_mismatch_and_fallback)."""
    cfg = tiny[0]
    jeng, teng = _engines(tiny, _rt({"dynamic_compression_ratio": True, "max_input_length": 16}))
    rng = np.random.default_rng(9)
    ids1, patches, grid = _request(cfg, rng, [20, 21, 22])
    ids2, _, _ = _request(cfg, rng, rng.integers(10, 500, size=40).tolist())
    prefix = teng.encode_prefix(ids1, patches, grid, max_new_tokens=4)
    jprefix = jeng.encode_prefix(ids1, patches, grid, max_new_tokens=4)
    bad = ids1.copy()
    bad[0] = 99
    for ids in (ids2, bad):
        with pytest.raises(jengine.PrefixMismatch):
            jeng.generate(ids, prefix=jprefix, max_new_tokens=4)
        with pytest.raises(tengine.PrefixMismatch):
            teng.generate(ids, prefix=prefix, max_new_tokens=4)
    inline = teng.generate(ids2, patches, grid, max_new_tokens=4)
    fallback = teng.generate(ids2, video_features=prefix.features, max_new_tokens=4)
    np.testing.assert_array_equal(fallback.tokens, inline.tokens)
    np.testing.assert_array_equal(
        fallback.tokens, jeng.generate(ids2, patches, grid, max_new_tokens=4).tokens)


def test_prefix_guard_rails(tiny):
    """Prompt-guided compression raises PrefixUnsupported (a ValueError
    naming it); a prompt that ends with the video span raises ValueError
    ("trailing text"); a question that outgrows the captured budget raises
    PrefixBudgetOverflow (tests/test_prefix_reuse.py
    ::test_qwen_prefix_guard_rails)."""
    cfg = tiny[0]
    ids, patches, grid = _request(cfg, np.random.default_rng(10), [20, 21, 22])
    guided = {"longvideo_kwargs": {
        "frame_chunk_size": 4, "chunked_prefill_frames": 2, "kvcache_compression": True,
        "kvcache_compression_kwargs": {"compression_ratio": 0.5, "compression_method": "pivotkv",
                                       "pos_embed_reforge": True,
                                       "prompt_guided_compression": True},
    }}
    for eng, unsupported in zip(_engines(tiny, guided),
                                (jengine.PrefixUnsupported, tengine.PrefixUnsupported)):
        with pytest.raises(unsupported, match="prompt_guided"):
            eng.encode_prefix(ids, patches, grid, max_new_tokens=4)
    no_suffix = ids[: int(np.where(ids == cfg.vision_end_token_id)[0][0])]
    jeng, teng = _engines(tiny, _rt({"compression_ratio": 0.5}))
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="trailing text"):
            eng.encode_prefix(no_suffix, patches, grid, max_new_tokens=4)
    prefix = teng.encode_prefix(ids, patches, grid, max_new_tokens=4, reserve_tokens=0)
    jprefix = jeng.encode_prefix(ids, patches, grid, max_new_tokens=4, reserve_tokens=0)
    big = prefix.budget  # more new tokens than the capture's budget holds
    with pytest.raises(jengine.PrefixBudgetOverflow):
        jeng.generate(ids, prefix=jprefix, max_new_tokens=big)
    with pytest.raises(tengine.PrefixBudgetOverflow):
        teng.generate(ids, prefix=prefix, max_new_tokens=big)


def test_prefix_batched_decode(tiny):
    """Prefill states resumed from a prefix decode together in
    ``decode_batch`` with the tokens of sequential reuse and of the JAX
    engine (tests/test_prefix_reuse.py::test_qwen_prefix_batched_decode)."""
    cfg, jp, model = tiny
    rd = _rt({"compression_ratio": 0.5})
    jeng, teng = _engines(tiny, rd)
    rng = np.random.default_rng(11)
    ids1, patches, grid = _request(cfg, rng, [20, 21, 22, 23, 24])
    ids2, _, _ = _request(cfg, rng, [30, 31, 32, 33, 34])
    prefix = teng.encode_prefix(ids1, patches, grid, max_new_tokens=6)
    jprefix = jeng.encode_prefix(ids1, patches, grid, max_new_tokens=6)
    seq = [teng.generate(i, prefix=prefix, max_new_tokens=6) for i in (ids1, ids2)]
    states = [teng.generate(i, prefix=prefix, max_new_tokens=6, _prefill_only=True)
              for i in (ids1, ids2)]
    batched = tengine.decode_batch(model, teng.cfg, teng.retake, states, 6)
    jstates = [jeng.generate(i, prefix=jprefix, max_new_tokens=6, _prefill_only=True)
               for i in (ids1, ids2)]
    want = jengine.decode_batch(jp, jeng.cfg, jeng.retake, jstates, 6)
    for s, b, w in zip(seq, batched, want):
        np.testing.assert_array_equal(b.tokens, s.tokens)
        np.testing.assert_array_equal(b.tokens, w.tokens)
