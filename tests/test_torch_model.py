"""Port model and engine against the JAX package on the CPU, fp32, same
weights (the JAX init through the port's weight bridge) and same inputs
(numpy seed): ViT block/tower and the K3 wrapper, ``decoder_chunk`` with
and without PivotKV compression and reforge, and the whole ReTaKe request
(``generate``), which must give the JAX engine's tokens exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu.models.qwen2_vl import text as jtext
from retake_tpu.models.qwen2_vl import vision as jvision
from retake_tpu.ops.pallas.vit_attention import vit_attention_qkv as jvit_attn
from retake_tpu.runtime import cache as jcache
from retake_tpu.runtime.engine import Qwen2VLEngine as JaxEngine
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.models.qwen2_vl import text as ttext
from retake_tpu_torch.models.qwen2_vl import vision as tvision
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.ops.cuda import vit_attention
from retake_tpu_torch.runtime import cache as tcache
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import npy, port_cfg, port_params, tiny_cfg, tt, video_request


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg()
    jp = jparams.init_params(cfg, seed=0, dtype=jnp.float32)
    model = Qwen2VLModel(port_cfg(cfg), port_params(jp))
    return cfg, jp, model


# ---------------------------------------------------------------- weights


def test_weight_bridge_keeps_keys_layouts_and_values(tiny):
    cfg, jp, model = tiny
    flat = {
        ".".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]
    }
    state = model.state_dict()
    assert set(state) == set(flat)
    for name, want in flat.items():
        got = npy(state[name])
        if name == "visual.blocks.qkv.w":  # stored head-major (see vision.py)
            l_, d, _ = want.shape
            nh, hd = cfg.vision.num_heads, cfg.vision.head_dim
            want = want.reshape(l_, d, 3, nh, hd).swapaxes(2, 3).reshape(l_, d, -1)
        elif name == "visual.blocks.qkv.b":
            l_ = want.shape[0]
            nh, hd = cfg.vision.num_heads, cfg.vision.head_dim
            want = want.reshape(l_, 3, nh, hd).swapaxes(1, 2).reshape(l_, -1)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_weight_bridge_bf16_bits():
    x = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    leaf = jnp.asarray(x, jnp.bfloat16)
    from retake_tpu_torch.models.qwen2_vl.params import from_jax_params

    got = from_jax_params({"a": {"b": leaf}})["a"]["b"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(leaf.astype(jnp.float32)))


def test_init_params_shapes_match_jax_tree():
    cfg = tiny_cfg()
    jp = jax.eval_shape(lambda: jparams._init_params_traced(cfg, 0, jnp.float32))
    from retake_tpu_torch.models.qwen2_vl.params import init_params

    tp = init_params(port_cfg(cfg), seed=0, dtype=torch.float32, device="cpu")
    want = jax.tree.map(lambda a: tuple(a.shape), jp)
    got = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert got == want
    again = init_params(port_cfg(cfg), seed=0, dtype=torch.float32, device="cpu")
    assert torch.equal(tp["layers"]["q"]["w"], again["layers"]["q"]["w"])  # seeded


# ---------------------------------------------------------------- vision / K3


@pytest.mark.parametrize("grid", [(2, 4, 4), (3, 4, 6)])
def test_vit_attention_wrapper_matches_jax_kernel(rng, grid):
    """K3 wrapper (plain on CPU) vs the JAX Pallas kernel; fp32, atol 1e-5."""
    t, h, w = grid
    n, d = 2, 16
    qkv = rng.normal(size=(t, h * w, n, 3, d)).astype(np.float32)
    cos, sin = tvision.vision_rotary_tables(h, w, d, 2)
    jcos, jsin = jvision.vision_rotary_tables(h, w, d, 2)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    want = jvit_attn(jnp.asarray(qkv), jnp.asarray(jcos), jnp.asarray(jsin))
    got = vit_attention.vit_attention_qkv(tt(qkv), tt(cos), tt(sin))
    np.testing.assert_allclose(npy(got), np.asarray(want), atol=1e-5)


def test_vit_block_matches_jax(tiny, rng):
    cfg, jp, model = tiny
    v = cfg.vision
    x = rng.normal(size=(2, 16, v.embed_dim)).astype(np.float32)
    jcos, jsin = jvision.vision_rotary_tables(4, 4, v.head_dim, 2)
    bp = jax.tree.map(lambda a: a[0], jp["visual"]["blocks"])
    want = jvision._block(v, jnp.asarray(jcos), jnp.asarray(jsin), jnp.asarray(x), bp, False)
    cos, sin = model.visual.rotary(4, 4, "cpu")
    got = tvision._block(v, cos, sin, tt(x), model.visual.blocks.layer(0), "pallas")
    np.testing.assert_allclose(npy(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("grid", [(2, 4, 4), (4, 4, 8)])
@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_vision_tower_matches_jax(tiny, rng, grid, attn_impl):
    cfg, jp, model = tiny
    t, h, w = grid
    patches = rng.normal(size=(t * h * w, cfg.vision.patch_input_dim)).astype(np.float32)
    want = jvision.vision_tower(jp["visual"], cfg.vision, jnp.asarray(patches), t, h, w)
    got = model.visual(tt(patches), t, h, w, attn_impl)
    np.testing.assert_allclose(npy(got), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------- decoder


def _chunk_inputs(cfg, rng):
    d = cfg.hidden_size
    first = rng.normal(size=(8, d)).astype(np.float32) * 0.5
    second = rng.normal(size=(16, d)).astype(np.float32) * 0.5
    pos1 = np.broadcast_to(np.arange(8, dtype=np.int32), (3, 8)).copy()
    i = np.arange(16)
    pos2 = np.stack([8 + i // 4, 8 + (i % 4) // 2, 8 + i % 2]).astype(np.int32)
    keypatch = rng.random(16) < 0.25
    return first, second, pos1, pos2, keypatch


@pytest.mark.parametrize("compress,reforge", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_decoder_chunk_matches_jax(rng, compress, reforge, attn_impl):
    """A text chunk into an empty cache, then a ragged chunk (valid 13 of 16,
    keep 9) over the filled cache; YaRN x4. Hidden states and the cache's
    k, v (fp32, atol 1e-4), pos and length (exact) against JAX."""
    cfg = tiny_cfg(yarn_factor=4.0)
    jp = jparams.init_params(cfg, seed=1, dtype=jnp.float32)
    model = Qwen2VLModel(port_cfg(cfg), port_params(jp))
    first, second, pos1, pos2, keypatch = _chunk_inputs(cfg, rng)
    l_, kvh, hd, budget = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim, 32

    jkv = jcache.init_cache(l_, kvh, budget, hd, dtype=jnp.float32)
    _, jkv = jtext.decoder_chunk(
        jp, cfg, jkv, jnp.asarray(first), jnp.asarray(pos1), jnp.int32(8),
        jnp.zeros(8, bool), jnp.int32(8), compress=False, reforge=reforge, attn_impl=attn_impl,
    )
    jh, jkv = jtext.decoder_chunk(
        jp, cfg, jkv, jnp.asarray(second), jnp.asarray(pos2), jnp.int32(13),
        jnp.asarray(keypatch), jnp.int32(9), compress=compress, reforge=reforge,
        attn_impl=attn_impl,
    )

    pcfg = port_cfg(cfg)
    tkv = tcache.init_cache(l_, kvh, budget, hd, dtype=torch.float32, device="cpu")
    _, tkv = ttext.decoder_chunk(
        model, pcfg, tkv, tt(first), tt(pos1), 8, torch.zeros(8, dtype=torch.bool), 8,
        compress=False, reforge=reforge, attn_impl=attn_impl,
    )
    th, tkv = ttext.decoder_chunk(
        model, pcfg, tkv, tt(second), tt(pos2), 13, tt(keypatch), 9,
        compress=compress, reforge=reforge, attn_impl=attn_impl,
    )
    np.testing.assert_allclose(npy(th), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(npy(tkv.k), np.asarray(jkv.k), atol=1e-4)
    np.testing.assert_allclose(npy(tkv.v), np.asarray(jkv.v), atol=1e-4)
    np.testing.assert_array_equal(npy(tkv.pos), np.asarray(jkv.pos))
    assert int(tkv.length) == int(jkv.length) == (8 + (9 if compress else 13))


@pytest.mark.parametrize("advances", [(5, 3), (8, 8)])
def test_append_blocks_matches_jax(rng, advances):
    """In-place appends at the running offset == the JAX functional appends."""
    l_, kvh, budget, hd, s = 2, 2, 24, 4, 8
    jkv = jcache.init_cache(l_, kvh, budget, hd, dtype=jnp.float32)
    tkv = tcache.init_cache(l_, kvh, budget, hd, dtype=torch.float32, device="cpu")
    for adv in advances:
        k = rng.normal(size=(l_, kvh, s, hd)).astype(np.float32)
        v = rng.normal(size=(l_, kvh, s, hd)).astype(np.float32)
        pos = rng.integers(0, 99, size=(l_, 3, s)).astype(np.int32)
        jkv = jcache.append_blocks(jkv, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                                   jnp.int32(adv))
        tcache.append_blocks(tkv, tt(k), tt(v), tt(pos), adv)
    for name in ("k", "v", "pos", "length"):
        np.testing.assert_array_equal(npy(getattr(tkv, name)), np.asarray(getattr(jkv, name)))


def test_final_logits_and_embed_match_jax(tiny, rng):
    cfg, jp, model = tiny
    h = rng.normal(size=(cfg.hidden_size,)).astype(np.float32)
    np.testing.assert_allclose(
        npy(ttext.final_logits(model, port_cfg(cfg), tt(h))),
        np.asarray(jtext.final_logits(jp, cfg, jnp.asarray(h))), atol=1e-5,
    )
    ids = np.array([0, 7, 511, 3])
    np.testing.assert_array_equal(
        npy(ttext.embed(model, torch.from_numpy(ids))), np.asarray(jtext.embed(jp, jnp.asarray(ids)))
    )


# ---------------------------------------------------------------- the slice

RETAKE = {
    "scaling_factor": 4,
    "longvideo_kwargs": {
        "chunked_prefill_frames": 2,
        "frame_chunk_size": 4,
        "visual_compression": True,
        "visual_compression_kwargs": {
            "compression_ratio": 1.0,
            "compression_method": "Keyframe",
            "patch_sync": False,
            "return_keyframe_mask": True,
        },
        "kvcache_compression": True,
        "kvcache_compression_kwargs": {
            "dynamic_compression_ratio": True,
            "compression_method": "pivotkv",
            "pos_embed_reforge": True,
            "max_input_length": 24,
        },
    },
}
CHUNKED_ONLY = {"longvideo_kwargs": {"chunked_prefill_frames": 2, "frame_chunk_size": 2}}


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
@pytest.mark.parametrize("conf", ["retake", "chunked_only", "default"])
def test_generate_matches_jax_engine(tiny, rng, attn_impl, conf):
    """The whole request on fp32 CPU: ViT chunks, DPSelect mask, chunked
    prefill, PivotKV with reforge, YaRN, greedy decode -> the JAX engine's
    tokens, exactly, and the same cache plan."""
    cfg, jp, model = tiny
    rd = {"retake": RETAKE, "chunked_only": CHUNKED_ONLY, "default": {}}[conf]
    rd = dict(rd, attn_implementation=attn_impl)
    ids, patches, grid = video_request(cfg, rng, grid_t=8 if conf == "retake" else 4)
    want = JaxEngine(cfg, jp, JaxRetakeConfig.from_dict(rd)).generate(
        ids, patches, grid, max_new_tokens=8
    )
    got = Qwen2VLEngine(port_cfg(cfg), model, RetakeConfig.from_dict(rd), device="cpu").generate(
        ids, patches, grid, max_new_tokens=8
    )
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.cache_len == want.cache_len == got.cache_fill
    assert got.input_len == want.input_len
    if conf == "retake":
        assert got.cache_len < got.input_len  # PivotKV evicted
