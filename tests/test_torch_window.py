"""The static attention window against the JAX package, on the CPU in fp32.

The JAX engine gives every prefill step, the sequential decode loop and the
spec-decode loop a window: the prefix of the cache buffer the attention
reads, a multiple of 8192 covering the fill (``min(bucket, budget)``). The
port passes the same windows (``decoder_chunk(attn_budget=)``) and slices
the cache views before the plain attention arms. These cases use caches
whose budget spans two or more buckets, so the window is smaller than the
buffer: ``decoder_chunk`` per arm against the JAX function (fp32, atol
1e-4), a two-bucket request's tokens against the JAX engine's (its video
prefill captured once per arm, then ``generate(prefix=...)`` with spec
decode off and on), and the window being a view of the cache (no copy).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu.models.qwen2_vl import text as jtext
from retake_tpu.runtime import cache as jcache
from retake_tpu.runtime.engine import Qwen2VLEngine as JaxEngine
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.models.qwen2_vl import text as ttext
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.ops import attention as attn_ops
from retake_tpu_torch.ops import quantization as q8
from retake_tpu_torch.runtime import cache as tcache
from retake_tpu_torch.runtime import engine as tengine
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import npy, port_cfg, port_params, tiny_cfg, tt, video_request

# cache buffer 24576 (three buckets), filled to 9000, window 16384
BUDGET, FILL, WINDOW = 24576, 9000, 16384


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg(yarn_factor=4.0)
    jp = jparams.init_params(cfg, seed=1, dtype=jnp.float32)
    return cfg, jp, Qwen2VLModel(port_cfg(cfg), port_params(jp))


def _filled_caches(cfg, rng, quantized):
    """The same cache in both packages: random k/v over the whole buffer
    (the tail past the fill is garbage the masks must hide), increasing
    temporal positions, length FILL."""
    l_, kvh, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    k = rng.normal(size=(l_, kvh, BUDGET, hd)).astype(np.float32)
    v = rng.normal(size=(l_, kvh, BUDGET, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(BUDGET, dtype=np.int32), (l_, 3, BUDGET)).copy()
    scales = {}
    if quantized:
        kq, ks = q8.quantize_kv_block(tt(k))
        vq, vs = q8.quantize_kv_block(tt(v))
        k, v = npy(kq), npy(vq)
        scales = dict(k_scale=npy(ks), v_scale=npy(vs))
    jkv = jcache.KVCache(k=jnp.asarray(k), v=jnp.asarray(v), pos=jnp.asarray(pos),
                         length=jnp.int32(FILL), **{n: jnp.asarray(x) for n, x in scales.items()})
    tkv = tcache.KVCache(k=tt(k), v=tt(v), pos=tt(pos), length=torch.tensor(FILL, dtype=torch.int32),
                         **{n: tt(x) for n, x in scales.items()})
    return jkv, tkv


def _arms():
    return [("xla", False), ("flash", False), ("pallas", False), ("xla", True), ("flash", True)]


@pytest.mark.parametrize("attn_impl,quantized", _arms())
def test_windowed_decoder_chunk_matches_jax(tiny, rng, attn_impl, quantized):
    """A ragged chunk (valid 13 of 16, keep 9, PivotKV with reforge) and
    then one decode token over a cache filled past the first bucket, both
    with ``attn_budget`` = 16384 of a 24576-key buffer: hidden states and
    the cache (k, v, pos, length; int8 scales) against JAX. Under "pallas"
    the JAX kernel reads the window and the port's K1 twin the whole
    buffer, as K1 does on the card."""
    cfg, jp, model = tiny
    pcfg = port_cfg(cfg)
    jkv, tkv = _filled_caches(cfg, rng, quantized)
    x = rng.normal(size=(16, cfg.hidden_size)).astype(np.float32) * 0.5
    pos = np.broadcast_to(FILL + np.arange(16, dtype=np.int32), (3, 16)).copy()
    keypatch = rng.random(16) < 0.25
    tok = rng.normal(size=(1, cfg.hidden_size)).astype(np.float32) * 0.5
    pos1 = np.full((3, 1), FILL + 9, np.int32)

    jh, jkv = jtext.decoder_chunk(
        jp, cfg, jkv, jnp.asarray(x), jnp.asarray(pos), jnp.int32(13), jnp.asarray(keypatch),
        jnp.int32(9), compress=True, reforge=True, attn_impl=attn_impl, attn_budget=WINDOW,
    )
    jh1, jkv = jtext.decoder_chunk(
        jp, cfg, jkv, jnp.asarray(tok), jnp.asarray(pos1), jnp.int32(1), jnp.zeros(1, bool),
        jnp.int32(1), compress=False, reforge=True, attn_impl=attn_impl, attn_budget=WINDOW,
    )
    th, tkv = ttext.decoder_chunk(
        model, pcfg, tkv, tt(x), tt(pos), 13, tt(keypatch), 9, compress=True, reforge=True,
        attn_impl=attn_impl, attn_budget=WINDOW,
    )
    th1, tkv = ttext.decoder_chunk(
        model, pcfg, tkv, tt(tok), tt(pos1), 1, torch.zeros(1, dtype=torch.bool), 1,
        compress=False, reforge=True, attn_impl=attn_impl, attn_budget=WINDOW,
    )
    np.testing.assert_allclose(npy(th), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(npy(th1), np.asarray(jh1), atol=1e-4)
    names = ("k", "v") + (("k_scale", "v_scale") if quantized else ())
    for name in names:
        np.testing.assert_allclose(npy(getattr(tkv, name)).astype(np.float32),
                                   np.asarray(getattr(jkv, name)).astype(np.float32),
                                   atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(npy(tkv.pos), np.asarray(jkv.pos))
    assert int(tkv.length) == int(jkv.length) == FILL + 10


def test_window_is_a_view_of_the_cache(tiny, rng, monkeypatch):
    """The plain arms get ``cache.k[i][:, :w]``: the same storage, ``w``
    keys, no copy; the cache writes still address the whole buffer."""
    cfg, _, model = tiny
    _, tkv = _filled_caches(cfg, rng, quantized=False)
    seen = []
    real = attn_ops.flash_chunk_attention

    def spy(query, key_cache, value_cache, *a, **kw):
        seen.append((key_cache, value_cache))
        return real(query, key_cache, value_cache, *a, **kw)

    monkeypatch.setattr(attn_ops, "flash_chunk_attention", spy)
    x = tt(rng.normal(size=(16, cfg.hidden_size)).astype(np.float32))
    pos = tt(np.broadcast_to(FILL + np.arange(16, dtype=np.int32), (3, 16)).copy())
    ttext.decoder_chunk(model, port_cfg(cfg), tkv, x, pos, 16, torch.zeros(16, dtype=torch.bool),
                        16, compress=False, reforge=False, attn_impl="flash",
                        attn_budget=WINDOW)
    assert len(seen) == cfg.num_hidden_layers
    for i, (kc, vc) in enumerate(seen):
        assert kc.shape[1] == vc.shape[1] == WINDOW
        assert kc.data_ptr() == tkv.k[i].data_ptr() and vc.data_ptr() == tkv.v[i].data_ptr()
        assert kc.stride() == tkv.k[i].stride() and not kc.is_contiguous()
    assert tkv.k.shape[2] == BUDGET and int(tkv.length) == FILL + 16


def test_plan_carries_the_window():
    """Each step's bucket covers the cache after it (JAX engine.py:1314,
    :1332): a text step over 9000 cached entries gets 16384."""
    ids = np.array([9] * 3 + [6] * 9000 + [7] * 5)
    plan, final_len, _ = tengine.plan_chunks(ids, 6, 2048, 1.0, False)
    assert [p["bucket"] for p in plan] == [8192, 8192, 8192, 8192, 16384, 16384, 16384]
    assert final_len == 9008


# ------------------------------------------------------ whole requests

# 256 raw frames of 16x16 patches: 8192 video tokens in 512-token chunks,
# so the prefill fills past the first bucket (budget 16384, windows 8192
# then 16384). Two query heads over one KV head keep the plain attention
# over 8192-key windows cheap on the CPU
GRID = dict(grid_t=128, grid_h=16, grid_w=16, prompt_len=5)
RD = {"longvideo_kwargs": {"frame_chunk_size": 64, "chunked_prefill_frames": 16}}


@pytest.fixture(scope="module")
def narrow():
    cfg = tiny_cfg(yarn_factor=4.0, num_attention_heads=2, num_key_value_heads=1,
                   mrope_section=(8, 4, 4))
    jp = jparams.init_params(cfg, seed=2, dtype=jnp.float32)
    return cfg, jp, Qwen2VLModel(port_cfg(cfg), port_params(jp))


def _rt(cls, impl, spec):
    return dataclasses.replace(cls.from_dict(dict(RD, attn_implementation=impl)),
                               spec_decode=spec)


@pytest.fixture(scope="module")
def request_runs(narrow):
    """The JAX engine's tokens for one two-bucket request per arm, spec
    decode off and on. The video prefill runs once per arm
    (``encode_prefix``, whose steps take the prefill windows); each
    ``generate(prefix=...)`` runs the question's step and the decode loop
    in their windows (JAX prefix reuse is token-exact against inline,
    tests/test_prefix_reuse.py)."""
    cfg, jp, _ = narrow
    req = video_request(cfg, np.random.default_rng(7), **GRID)
    want = {}
    for impl in ("xla", "flash"):
        prefix = JaxEngine(cfg, jp, _rt(JaxRetakeConfig, impl, False)).encode_prefix(
            *req, max_new_tokens=6)
        for spec in (False, True):
            want[impl, spec] = JaxEngine(cfg, jp, _rt(JaxRetakeConfig, impl, spec)).generate(
                req[0], prefix=prefix, max_new_tokens=6).tokens
    return req, want


@pytest.fixture(scope="module")
def port_prefixes(narrow, request_runs):
    """The port's captures of the same request, one per arm."""
    cfg, _, model = narrow
    req, _ = request_runs
    return {impl: Qwen2VLEngine(port_cfg(cfg), model, _rt(RetakeConfig, impl, False),
                                device="cpu").encode_prefix(*req, max_new_tokens=6)
            for impl in ("xla", "flash")}


@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_two_bucket_generate_matches_jax(narrow, request_runs, port_prefixes, attn_impl, spec):
    cfg, _, model = narrow
    req, want = request_runs
    prefix = port_prefixes[attn_impl]
    assert prefix.final_len > 8192 and prefix.budget == 16384
    got = Qwen2VLEngine(port_cfg(cfg), model, _rt(RetakeConfig, attn_impl, spec),
                        device="cpu").generate(req[0], prefix=prefix, max_new_tokens=6)
    assert got.cache_len > 8192
    np.testing.assert_array_equal(got.tokens, want[attn_impl, spec])
