"""The port's per-question engine paths against the JAX engine on the CPU,
fp32, same weights (the JAX init through the port's weight bridge) and same
inputs (numpy seed): still images and mixed image + video prompts
(``run_vision_images``, image positions, the image-span scatter),
prompt-guided compression (the ``[video | prompt | pad]`` chunk and its
host plan) and prompt-lookup speculative decode.

Tolerances: tokens, cache plans and (m, n_it) exact; ViT outputs atol 1e-4;
one ``decoder_chunk`` step's hidden states and cache k/v atol 1e-4, its
positions and length exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu.runtime import cache as jcache
from retake_tpu.runtime import engine as jengine
from retake_tpu.runtime.engine import Qwen2VLEngine as JaxEngine
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.models.qwen2_vl import text as ttext
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.runtime import cache as tcache
from retake_tpu_torch.runtime import engine as tengine
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import npy, port_cfg, port_params, tiny_cfg, tt, video_request

CHUNKED = {"chunked_prefill_frames": 2, "frame_chunk_size": 2}
# tests/test_engine.py::test_prompt_guided_compression's config
PROMPT_GUIDED = {
    "longvideo_kwargs": {
        "chunked_prefill_frames": 2,
        "frame_chunk_size": 4,
        "kvcache_compression": True,
        "kvcache_compression_kwargs": {
            "dynamic_compression_ratio": True,
            "compression_method": "pivotkv",
            "pos_embed_reforge": True,
            "prompt_guided_compression": True,
            "max_input_length": 24,
        },
    }
}
# tests/test_engine.py::test_spec_decode_matches_vanilla's config
SPEC = {
    "longvideo_kwargs": {
        "chunked_prefill_frames": 2,
        "frame_chunk_size": 2,
        "kvcache_compression": True,
        "kvcache_compression_kwargs": {"compression_ratio": 0.6, "pos_embed_reforge": True},
    }
}


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


def _images(cfg, rng, grids):
    """Concatenated image patches and [n, 3] grids (the HF pixel_values
    layout; tests/test_engine.py make_image_inputs)."""
    total = sum(t * h * w for t, h, w in grids)
    patches = rng.normal(size=(total, cfg.vision.patch_input_dim)).astype(np.float32)
    return patches, np.asarray(grids, dtype=np.int64)


# ---------------------------------------------------------------- images


def test_run_vision_images_matches_jax(tiny):
    """One ViT pass per image over its own (1, h, w) grid, outputs in input
    order."""
    jeng, teng = _engines(tiny, {})
    pixels, grids = _images(tiny[0], np.random.default_rng(0), [(1, 4, 4), (1, 2, 4), (1, 6, 4)])
    want = jeng.run_vision_images(pixels, grids)
    got = teng.run_vision_images(pixels, grids)
    assert got.shape == (16 // 4 + 8 // 4 + 24 // 4, tiny[0].hidden_size)
    np.testing.assert_allclose(npy(got), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_image_only_matches_jax(tiny, attn_impl):
    """A still image between text (tests/test_engine.py
    ::test_generate_matches_hf_image_only)."""
    cfg = tiny[0]
    pixels, grids = _images(cfg, np.random.default_rng(1), [(1, 4, 4)])
    ids = np.array([10, 11, cfg.vision_start_token_id] + [cfg.image_token_id] * 4
                   + [cfg.vision_end_token_id, 30, 31, 32], dtype=np.int64)
    jeng, teng = _engines(tiny, {"attn_implementation": attn_impl})
    want = jeng.generate(ids, max_new_tokens=6, pixel_values=pixels, image_grid_thw=grids)
    got = teng.generate(ids, max_new_tokens=6, pixel_values=pixels, image_grid_thw=grids)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.cache_len == want.cache_len == len(ids)


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_mixed_image_video_image_chunked_matches_jax(tiny, attn_impl):
    """Image + video + image with chunked prefill: the images ride the text
    segments, only the video span chunks (tests/test_engine.py
    ::test_generate_matches_hf_mixed_image_video_chunked)."""
    cfg = tiny[0]
    rng = np.random.default_rng(2)
    vid_ids, patches, grid = video_request(cfg, rng, grid_t=4)
    pixels, grids = _images(cfg, rng, [(1, 4, 4), (1, 2, 4)])
    ids = np.concatenate([
        [12, cfg.vision_start_token_id], [cfg.image_token_id] * 4, [cfg.vision_end_token_id],
        vid_ids,
        [cfg.vision_start_token_id], [cfg.image_token_id] * 2,
        [cfg.vision_end_token_id, 40, 41],
    ]).astype(np.int64)
    jeng, teng = _engines(tiny, {"attn_implementation": attn_impl, "longvideo_kwargs": CHUNKED})
    kw = dict(max_new_tokens=6, pixel_values=pixels, image_grid_thw=grids)
    want = jeng.generate(ids, patches, grid, **kw)
    got = teng.generate(ids, patches, grid, **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.cache_len == want.cache_len == got.cache_fill


# ---------------------------------------------------------------- prompt-guided


@pytest.mark.parametrize("valid", [16, 13])
def test_prompt_block_decoder_chunk_matches_jax(tiny, rng, valid):
    """One ``[video | prompt | pad]`` chunk (16 video rows, ``valid`` of
    them live, a 5-token prompt, keep 9) over a cache holding 8 text
    tokens: ``_prompt_block`` + ``decoder_chunk`` against the JAX
    ``_video_chunk_with_prompt_step``, with compression and reforge."""
    cfg, jp, model = tiny
    pcfg = port_cfg(cfg)
    d, n, pl, off, p_off, keep = cfg.hidden_size, 16, 5, 8, 30, 9
    embeds = (rng.normal(size=(40, d)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (3, 40)).copy()
    pos[1:, off : off + n] += np.arange(n, dtype=np.int32) % 4
    kp = rng.random(40) < 0.3
    l_, kvh, hd, budget = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim, 64

    jkv = jcache.init_cache(l_, kvh, budget, hd, dtype=jnp.float32)
    _, jkv = jengine._segment_step(jp, cfg, jkv, jnp.asarray(embeds), jnp.asarray(pos),
                                   jnp.asarray(kp), jnp.int32(0), jnp.int32(8), jnp.int32(8),
                                   8, False, True, "pallas")
    jh, jkv = jengine._video_chunk_with_prompt_step(
        jp, cfg, jkv, jnp.asarray(embeds), jnp.asarray(pos), jnp.asarray(kp), jnp.int32(off),
        jnp.int32(valid), jnp.int32(keep), jnp.int32(p_off), n, pl, True, True, "pallas",
    )

    tkv = tcache.init_cache(l_, kvh, budget, hd, dtype=torch.float32, device="cpu")
    _, tkv = ttext.decoder_chunk(model, pcfg, tkv, tt(embeds[:8]), tt(pos[:, :8]), 8,
                                 tt(kp[:8]), 8, compress=False, reforge=True, attn_impl="pallas")
    step = dict(offset=off, valid=valid, chunk_len=n, prompt_len=pl)
    x, p3, kpb = tengine._prompt_block(tt(embeds), tt(pos), tt(kp), step, p_off)
    assert x.shape == (n + pl, d) and not kpb[valid : valid + pl].any()
    th, tkv = ttext.decoder_chunk(model, pcfg, tkv, x, p3, valid + pl, kpb, keep,
                                  compress=True, reforge=True, attn_impl="pallas")
    np.testing.assert_allclose(npy(th), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(npy(tkv.k), np.asarray(jkv.k), atol=1e-4)
    np.testing.assert_allclose(npy(tkv.v), np.asarray(jkv.v), atol=1e-4)
    np.testing.assert_array_equal(npy(tkv.pos), np.asarray(jkv.pos))
    assert int(tkv.length) == int(jkv.length) == 8 + keep


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_prompt_guided_request_matches_jax(tiny, attn_impl):
    """The request of tests/test_engine.py::test_prompt_guided_compression:
    tokens and the cache length pre + 8 x int(ratio * (4 + 5)) + post."""
    cfg = tiny[0]
    ids, patches, grid = video_request(cfg, np.random.default_rng(3), grid_t=8, prompt_len=4)
    jeng, teng = _engines(tiny, dict(PROMPT_GUIDED, attn_implementation=attn_impl))
    want = jeng.generate(ids, patches, grid, max_new_tokens=4)
    got = teng.generate(ids, patches, grid, max_new_tokens=4)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    expected = 4 + 8 * int(24 / len(ids) * (4 + 5)) + 5
    assert got.cache_len == want.cache_len == got.cache_fill == expected


def test_prompt_guided_plan_carries_the_prompt():
    """Every video chunk of the plan carries the trailing text segment."""
    ids = np.array([9, 9, 3] + [6] * 10 + [4, 7, 7, 7])
    plan, final_len, extent = tengine.plan_chunks(ids, 6, 4, 0.5, True, prompt_guided=True)
    video = [p for p in plan if p["kind"] == "video"]
    assert [p["valid"] for p in video] == [4, 4, 2]
    assert all(p["prompt_len"] == 4 for p in video)
    assert [p["keep"] for p in video] == [4, 4, 3]
    assert final_len == 3 + 11 + 4 and extent >= 3 + 8 + 4 + 4


# ---------------------------------------------------------------- spec decode


@pytest.fixture(scope="module")
def spec_runs(tiny):
    """The JAX spec-decode loop's tokens and (m, n_it) on the requests of
    tests/test_engine.py::test_spec_decode_matches_vanilla (seeds 4 and 5,
    33 new tokens), and the JAX greedy tokens."""
    cfg, jp, _ = tiny
    jeng = JaxEngine(cfg, jp, JaxRetakeConfig.from_dict(SPEC))
    jspec = JaxEngine(cfg, jp, dataclasses.replace(JaxRetakeConfig.from_dict(SPEC),
                                                   spec_decode=True))
    real = jengine._spec_decode_loop
    counts = []

    def recording(*a, **kw):
        out = real(*a, **kw)
        counts.append((int(out[2]), int(out[3])))
        return out

    runs = {}
    jengine._spec_decode_loop = recording
    try:
        for seed in (4, 5):
            req = video_request(cfg, np.random.default_rng(seed), grid_t=4, prompt_len=5)
            runs[seed] = (req, jspec.generate(*req, max_new_tokens=33).tokens, counts[-1],
                          jeng.generate(*req, max_new_tokens=33).tokens)
    finally:
        jengine._spec_decode_loop = real
    return runs


@pytest.mark.parametrize("seed", [4, 5])
def test_spec_decode_matches_jax(tiny, spec_runs, seed):
    """Tokens and (m, n_it) of the JAX loop, and the port's own vanilla
    greedy tokens."""
    cfg, _, model = tiny
    req, want, want_steps, greedy = spec_runs[seed]
    rt = RetakeConfig.from_dict(SPEC)
    spec = Qwen2VLEngine(port_cfg(cfg), model, dataclasses.replace(rt, spec_decode=True),
                         device="cpu").generate(*req, max_new_tokens=33)
    vanilla = Qwen2VLEngine(port_cfg(cfg), model, rt, device="cpu").generate(*req, max_new_tokens=33)
    np.testing.assert_array_equal(spec.tokens, want)
    np.testing.assert_array_equal(vanilla.tokens, greedy)
    np.testing.assert_array_equal(spec.tokens, vanilla.tokens)
    assert spec.spec_steps == want_steps
    m, n_it = spec.spec_steps
    assert spec.stages["spec_tokens_per_step"] == round(m / n_it, 3)


def test_spec_decode_accepts_and_stops_at_eos(tiny, spec_runs):
    """At least one request accepts multi-token runs, and with EOS rebound
    to a token the stream emits, spec decode stops where vanilla does."""
    cfg, _, model = tiny
    assert any(m > n_it for _, _, (m, n_it), _ in spec_runs.values())
    req, want, _, _ = spec_runs[5]
    cfg2 = dataclasses.replace(cfg, eos_token_id=int(want[5]))
    rt = RetakeConfig.from_dict(SPEC)
    x = Qwen2VLEngine(port_cfg(cfg2), model, rt, device="cpu").generate(*req, max_new_tokens=33)
    y = Qwen2VLEngine(port_cfg(cfg2), model, dataclasses.replace(rt, spec_decode=True),
                      device="cpu").generate(*req, max_new_tokens=33)
    np.testing.assert_array_equal(y.tokens, x.tokens)
    assert len(x.tokens) < 33
