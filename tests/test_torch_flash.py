"""The ``attn_implementation: "flash"`` arm of the port against the JAX
package on the CPU, fp32, same weights and inputs:
``ops/attention.flash_chunk_attention`` (tests/test_attention.py's cases,
block-size invariance, the int8 cache; 1e-5), ``decoder_chunk`` under
"flash" with PivotKV compression and reforge, ``generate`` under "flash"
(the JAX engine's tokens), "pallas" against "flash" through the whole
ReTaKe pipeline (tests/test_engine.py::test_pallas_impl_matches_flash_full_pipeline),
and the server with ``decode_attn_impl="flash"`` (K4's plain twin on the
CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu.models.qwen2_vl import text as jtext
from retake_tpu.ops import attention as jattn
from retake_tpu.ops.quantization import quantize_kv_block as jquant_kv
from retake_tpu.runtime import cache as jcache
from retake_tpu.runtime.engine import Qwen2VLEngine as JaxEngine
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.models.qwen2_vl import text as ttext
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.ops import attention as tattn
from retake_tpu_torch.ops.cuda import vit_attention
from retake_tpu_torch.runtime import cache as tcache
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.runtime.serve import ContinuousServer
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import npy, port_cfg, port_params, tiny_cfg, tt, video_request

RETAKE = {  # tests/test_engine.py's full pipeline: DPSelect mask, PivotKV + reforge
    "longvideo_kwargs": {
        "chunked_prefill_frames": 2, "frame_chunk_size": 4,
        "visual_compression": True,
        "visual_compression_kwargs": {"compression_ratio": 1.0, "compression_method": "Keyframe",
                                      "return_keyframe_mask": True},
        "kvcache_compression": True,
        "kvcache_compression_kwargs": {"dynamic_compression_ratio": True,
                                       "compression_method": "pivotkv",
                                       "pos_embed_reforge": True, "max_input_length": 24},
    }
}


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg()
    jp = jparams.init_params(cfg, seed=0, dtype=jnp.float32)
    return cfg, jp, Qwen2VLModel(port_cfg(cfg), port_params(jp))


def _attn_inputs(rng, h, kv, s, budget, d=16):
    draw = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return draw(h, s, d), draw(kv, budget, d), draw(kv, budget, d), draw(kv, s, d), draw(kv, s, d)


@pytest.mark.parametrize("block", [32, 1024])
@pytest.mark.parametrize("h,kv,s,budget,cache_len,valid", [
    (4, 2, 16, 64, 20, 16),
    (4, 2, 16, 64, 0, 9),  # empty cache, padded chunk tail
    (8, 2, 33, 128, 127, 33),  # nearly full cache, odd chunk length
    (4, 1, 40, 100, 57, 31),  # tail blocks that clamp left in both phases
])
def test_flash_matches_jax(rng, h, kv, s, budget, cache_len, valid, block):
    """The port's flash chunk attention == JAX's (1e-5, every row, padding
    rows too), and == the full masked softmax on the valid rows."""
    q, kc, vc, kn, vn = _attn_inputs(rng, h, kv, s, budget)
    want = jattn.flash_chunk_attention(*map(jnp.asarray, (q, kc, vc)), jnp.int32(cache_len),
                                       jnp.asarray(kn), jnp.asarray(vn), jnp.int32(valid),
                                       block_size=block)
    got = tattn.flash_chunk_attention(tt(q), tt(kc), tt(vc), torch.tensor(cache_len), tt(kn),
                                      tt(vn), torch.tensor(valid), block_size=block)
    np.testing.assert_allclose(npy(got), np.asarray(want), atol=1e-5)
    full = tattn.chunk_prefill_attention(tt(q), tt(kc), tt(vc), cache_len, tt(kn), tt(vn), valid)
    np.testing.assert_allclose(npy(got)[:, :valid], npy(full)[:, :valid], atol=1e-5)


def test_flash_block_size_invariance(rng):
    q, kc, vc, kn, vn = _attn_inputs(rng, 4, 2, 24, 96)
    outs = [npy(tattn.flash_chunk_attention(tt(q), tt(kc), tt(vc), 50, tt(kn), tt(vn), 24,
                                            block_size=b)) for b in (16, 64, 1024)]
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)
    np.testing.assert_allclose(outs[0], outs[2], atol=1e-5)


@pytest.mark.parametrize("block", [16, 1024])
def test_flash_int8_cache_matches_jax(rng, block):
    """An int8 cache with per-key scales, dequantized block by block: JAX's
    output within 1e-5."""
    q, kc, vc, kn, vn = _attn_inputs(rng, 4, 2, 12, 48)
    (kq, ks), (vq, vs) = jquant_kv(jnp.asarray(kc)), jquant_kv(jnp.asarray(vc))
    want = jattn.flash_chunk_attention(jnp.asarray(q), kq, vq, jnp.int32(30), jnp.asarray(kn),
                                       jnp.asarray(vn), jnp.int32(10), block_size=block,
                                       k_scale=ks, v_scale=vs)
    got = tattn.flash_chunk_attention(tt(q), tt(kq), tt(vq), 30, tt(kn), tt(vn), 10,
                                      block_size=block, k_scale=tt(ks), v_scale=tt(vs))
    np.testing.assert_allclose(npy(got), np.asarray(want), atol=1e-5)


def _chunk_inputs(cfg, rng):
    d = cfg.hidden_size
    first = rng.normal(size=(8, d)).astype(np.float32) * 0.5
    second = rng.normal(size=(16, d)).astype(np.float32) * 0.5
    pos1 = np.broadcast_to(np.arange(8, dtype=np.int32), (3, 8)).copy()
    i = np.arange(16)
    pos2 = np.stack([8 + i // 4, 8 + (i % 4) // 2, 8 + i % 2]).astype(np.int32)
    return first, second, pos1, pos2, rng.random(16) < 0.25


@pytest.fixture(scope="module")
def yarn():
    cfg = tiny_cfg(yarn_factor=4.0)
    jp = jparams.init_params(cfg, seed=1, dtype=jnp.float32)
    return cfg, jp, Qwen2VLModel(port_cfg(cfg), port_params(jp))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("compress,reforge", [(False, False), (True, False), (True, True)])
def test_decoder_chunk_flash_matches_jax(yarn, rng, compress, reforge, int8):
    """A text chunk into an empty cache, then a ragged chunk (valid 13 of
    16, keep 9) over it, under "flash" (YaRN x4): hidden states, the cache's
    k, v (and the int8 cache's scales: the chunk quantized at the append),
    pos and length against JAX's "flash"; fp32, atol 1e-4 (int8 values
    exact, scales 1e-5)."""
    cfg, jp, model = yarn
    first, second, pos1, pos2, keypatch = _chunk_inputs(cfg, rng)
    l_, kvh, hd, budget = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim, 32
    jkv = jcache.init_cache(l_, kvh, budget, hd, dtype=jnp.float32, quantized=int8)
    tkv = tcache.init_cache(l_, kvh, budget, hd, dtype=torch.float32, device="cpu",
                            quantized=int8)
    for x, p, valid, kp, keep, comp in ((first, pos1, 8, np.zeros(8, bool), 8, False),
                                        (second, pos2, 13, keypatch, 9, compress)):
        jh, jkv = jtext.decoder_chunk(jp, cfg, jkv, jnp.asarray(x), jnp.asarray(p),
                                      jnp.int32(valid), jnp.asarray(kp), jnp.int32(keep),
                                      compress=comp, reforge=reforge, attn_impl="flash")
        th, tkv = ttext.decoder_chunk(model, port_cfg(cfg), tkv, tt(x), tt(p), valid, tt(kp), keep,
                                      compress=comp, reforge=reforge, attn_impl="flash")
    np.testing.assert_allclose(npy(th), np.asarray(jh), atol=1e-4)
    if int8:
        np.testing.assert_array_equal(npy(tkv.k), np.asarray(jkv.k))
        np.testing.assert_array_equal(npy(tkv.v), np.asarray(jkv.v))
    else:
        np.testing.assert_allclose(npy(tkv.k), np.asarray(jkv.k), atol=1e-4)
        np.testing.assert_allclose(npy(tkv.v), np.asarray(jkv.v), atol=1e-4)
    if int8:
        np.testing.assert_allclose(npy(tkv.k_scale), np.asarray(jkv.k_scale), atol=1e-5)
        np.testing.assert_allclose(npy(tkv.v_scale), np.asarray(jkv.v_scale), atol=1e-5)
    np.testing.assert_array_equal(npy(tkv.pos), np.asarray(jkv.pos))
    assert int(tkv.length) == int(jkv.length) == 8 + (9 if compress else 13)


def test_decoder_chunk_rejects_unknown_impl(tiny):
    cfg, _, model = tiny
    kv = tcache.init_cache(2, 2, 8, cfg.head_dim, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        ttext.decoder_chunk(model, port_cfg(cfg), kv, torch.zeros(4, cfg.hidden_size),
                            torch.zeros(3, 4, dtype=torch.int32), 4, None, 4, compress=False,
                            reforge=False, attn_impl="sdpa")


@pytest.mark.parametrize("conf", ["retake", "chunked_int8", "default"])
def test_generate_flash_matches_jax_engine(tiny, conf):
    """A whole request under attn_implementation "flash": the JAX engine's
    tokens and cache plan, exactly (the int8 KV cache included)."""
    cfg, jp, model = tiny
    rd = {"retake": RETAKE,
          "chunked_int8": {"kv_cache_dtype": "int8", "longvideo_kwargs": {
              "chunked_prefill_frames": 2, "frame_chunk_size": 2}},
          "default": {}}[conf]
    rd = dict(rd, attn_implementation="flash")
    ids, patches, grid = video_request(cfg, np.random.default_rng(3),
                                       grid_t=8 if conf == "retake" else 4)
    want = JaxEngine(cfg, jp, JaxRetakeConfig.from_dict(rd)).generate(ids, patches, grid,
                                                                     max_new_tokens=8)
    eng = Qwen2VLEngine(port_cfg(cfg), model, RetakeConfig.from_dict(rd), device="cpu")
    assert (eng.attn_impl, eng.vit_impl) == ("flash", "pallas")
    got = eng.generate(ids, patches, grid, max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.cache_len == want.cache_len == got.cache_fill


def test_pallas_impl_matches_flash_full_pipeline(tiny, monkeypatch):
    """"pallas" (the kernels' wrappers; their plain twins on the CPU) and
    "flash" give the same tokens and cache plan through the whole ReTaKe
    pipeline; the ViT takes the K3 wrapper under both."""
    cfg, _, model = tiny
    ids, patches, grid = video_request(cfg, np.random.default_rng(4), grid_t=8)
    calls = {"k3": 0}
    orig = vit_attention.vit_attention_qkv

    def counting(*a, **kw):
        calls["k3"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(vit_attention, "vit_attention_qkv", counting)
    out = {}
    for impl in ("flash", "pallas"):
        calls["k3"] = 0
        eng = Qwen2VLEngine(port_cfg(cfg), model,
                            RetakeConfig.from_dict(dict(RETAKE, attn_implementation=impl)),
                            device="cpu")
        out[impl] = (eng.generate(ids, patches, grid, max_new_tokens=5), calls["k3"])
    np.testing.assert_array_equal(out["pallas"][0].tokens, out["flash"][0].tokens)
    assert out["pallas"][0].cache_len == out["flash"][0].cache_len
    assert out["flash"][1] == out["pallas"][1] == cfg.vision.depth * 2  # 8 frames, chunks of 4


@pytest.mark.parametrize("engine_impl", ["pallas", "flash"])
def test_serve_flash_decode_matches_sequential(tiny, engine_impl):
    """ContinuousServer(decode_attn_impl="flash") decodes through K4 (its
    plain twin here), as "pallas" does: compactions included, the JAX
    sequential streams; with the engine under "flash" too."""
    cfg, jp, model = tiny
    rd = {"attn_implementation": engine_impl, "longvideo_kwargs": {
        "chunked_prefill_frames": 2, "frame_chunk_size": 2, "kvcache_compression": True,
        "kvcache_compression_kwargs": {"compression_ratio": 0.6, "pos_embed_reforge": True}}}
    rng = np.random.default_rng(0)
    reqs = [dict(zip(("input_ids", "pixel_values_videos", "video_grid_thw"),
                     video_request(cfg, rng, grid_t=2 + 2 * (i % 2), prompt_len=4 + i)))
            for i in range(3)]
    jeng = JaxEngine(cfg, jp, JaxRetakeConfig.from_dict(rd))
    seq = [jeng.generate(**r, max_new_tokens=9).tokens for r in reqs]
    eng = Qwen2VLEngine(port_cfg(cfg), model, RetakeConfig.from_dict(rd), device="cpu")
    calls = {"n": 0}
    orig = tattn.decode_attention_batch_gapped

    def spy(*a, **kw):
        assert kw["impl"] == "pallas"
        calls["n"] += 1
        return orig(*a, **kw)

    ttext.attn_ops.decode_attention_batch_gapped = spy
    try:
        srv = ContinuousServer(eng, batch_slots=2, segment_steps=3, max_new_tokens=9,
                               gap_capacity=6, decode_attn_impl="flash")
        res = srv.run([dict(r) for r in reqs])
    finally:
        ttext.attn_ops.decode_attention_batch_gapped = orig
    assert srv.decode_attn_impl == "flash" and calls["n"] > 0
    assert srv.stats["compactions"] >= 1
    for r, s in zip(res, seq):
        np.testing.assert_array_equal(r.tokens, s)
