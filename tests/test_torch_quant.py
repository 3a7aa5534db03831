"""The port's int8 paths against the JAX package on the CPU, fp32, inputs
from a numpy seed: the quantizers (bit-identical), the int8 / W8A8 linears,
the quantized weight trees and the weight bridge, the int8 embedding and LM
head, K1's and K4's int8-KV plain twins and the int8 arms of the plain
attentions (the JAX Pallas kernels in interpret mode), the int8 cache
through ``decoder_chunk``, the W8A8 vision tower, and whole ``generate`` /
``generate_batch`` requests under ``kv_cache_dtype: int8``, ``quantization:
int8`` and ``w8a8`` (exact tokens against the JAX engine). Tolerances are
stated per test. The JAX references that build models run once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu.models.qwen2_vl import text as jtext
from retake_tpu.models.qwen2_vl import vision as jvision
from retake_tpu.ops import attention as jattn
from retake_tpu.ops import quantization as jq8
from retake_tpu.ops.pallas.decode_gapped import decode_gapped_flash_state as jgapped
from retake_tpu.ops.pallas.flash_prefill import flash_prefill_attention as jflash
from retake_tpu.runtime import cache as jcache
from retake_tpu.runtime.engine import Qwen2VLEngine as JaxEngine
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.models.qwen2_vl import params as tparams
from retake_tpu_torch.models.qwen2_vl import text as ttext
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.ops import attention as tattn
from retake_tpu_torch.ops import quantization as tq8
from retake_tpu_torch.ops.cuda import decode_gapped, flash_prefill
from retake_tpu_torch.runtime import cache as tcache
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import npy, port_cfg, port_params, tiny_cfg, tt, video_request


def _quantized_jax_tree(jp):
    jq = jq8.quantize_llm_int8(jp)
    jq["visual"] = jq8.quantize_vit_int8(jq["visual"])
    return jq


@pytest.fixture(scope="module")
def tiny_q():
    """The tiny model's fp32 JAX tree, its int8 tree (LLM and ViT), and the
    port's model on the int8 tree."""
    cfg = tiny_cfg()
    jp = jparams.init_params(cfg, seed=0, dtype=jnp.float32)
    jq = _quantized_jax_tree(jp)
    return cfg, jp, jq, Qwen2VLModel(port_cfg(cfg), port_params(jq))


def _leaves(tree):
    return {
        ".".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _torch_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_torch_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------- quantizers


def _with_ties(x):
    """Rows whose amax is 127 (scale exactly 1): x.5 values round half to
    even; and an all-zero row (scale 1e-8 / 127)."""
    x = x.copy()
    flat = x.reshape(-1, x.shape[-1])
    flat[0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]
    flat[-1] = 0.0
    return x


@pytest.mark.parametrize("kind,shape", [
    ("weight", (32, 48)), ("weight", (3, 32, 48)), ("embedding", (40, 16)),
    ("kv_block", (2, 3, 24, 16)), ("kv_block", (2, 5, 4, 16)), ("acts", (5, 32)),
    ("acts", (2, 7, 32)),
])
def test_quantizers_bit_identical_to_jax(rng, kind, shape):
    """Same fp32 input -> the same int8 values and fp32 scales, bit for bit
    (round half to even on both sides)."""
    x = _with_ties((rng.normal(size=shape) * 3.0).astype(np.float32))
    if kind == "weight":
        x = np.swapaxes(_with_ties(np.swapaxes(x, -1, -2)), -1, -2)  # ties per column
        jd, td = jq8.quantize_weight(jnp.asarray(x)), tq8.quantize_weight(tt(x))
        want, got = (jd["w"], jd["scale"]), (td["w"], td["scale"])
    elif kind == "embedding":
        jd, td = jq8.quantize_embedding(jnp.asarray(x)), tq8.quantize_embedding(tt(x))
        want, got = (jd["w"], jd["scale"]), (td["w"], td["scale"])
    elif kind == "kv_block":
        want, got = jq8.quantize_kv_block(jnp.asarray(x)), tq8.quantize_kv_block(tt(x))
    else:
        want, got = jq8.quantize_acts(jnp.asarray(x)), tq8.quantize_acts(tt(x))
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(npy(g), np.asarray(w))


def test_quantizers_leave_their_input_alone(rng):
    x = tt(rng.normal(size=(4, 8)).astype(np.float32))
    before = x.clone()
    tq8.quantize_weight(x), tq8.quantize_kv_block(x), tq8.quantize_acts(x)
    assert torch.equal(x, before)


# ---------------------------------------------------------------- linears


@pytest.mark.parametrize("mode", ["float", "int8", "w8a8"])
@pytest.mark.parametrize("bias", [False, True])
def test_qlinear_matches_jax(rng, mode, bias):
    """qlinear's three arms on [2, 5, 32] x [32, 24] (+ bias) against JAX:
    1e-5 relative to the output's scale (the int32 sums are exact; the fp32
    products run in another order)."""
    x = (rng.normal(size=(2, 5, 32)) * 2.0).astype(np.float32)
    w = rng.normal(size=(32, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    jp = {"w": jnp.asarray(w)} if mode == "float" else jq8.quantize_weight(jnp.asarray(w))
    tp = {"w": tt(w)} if mode == "float" else tq8.quantize_weight(tt(w))
    if bias:
        jp, tp = dict(jp, b=jnp.asarray(b)), dict(tp, b=tt(b))
    want = np.asarray(jq8.qlinear(jnp.asarray(x), jp, mode == "w8a8"))
    got = npy(tq8.qlinear(tt(x), tp, mode == "w8a8"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_int8_linear_and_prequant_match_jax(rng):
    """int8_linear and int8_matmul_prequant (shared activation quantization)
    against JAX: 1e-5 relative to the output's scale."""
    x = (rng.normal(size=(7, 48)) * 5.0).astype(np.float32)
    w = rng.normal(size=(48, 16)).astype(np.float32)
    jd, td = jq8.quantize_weight(jnp.asarray(w)), tq8.quantize_weight(tt(w))
    want = np.asarray(jq8.int8_linear(jnp.asarray(x), jd["w"], jd["scale"]))
    got = npy(tq8.int8_linear(tt(x), td["w"], td["scale"]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    jxq, jxs = jq8.quantize_acts(jnp.asarray(x))
    txq, txs = tq8.quantize_acts(tt(x))
    want = np.asarray(jq8.int8_matmul_prequant(jxq, jxs, jd["w"], jd["scale"], jnp.float32))
    got = npy(tq8.int8_matmul_prequant(txq, txs, td["w"], td["scale"], torch.float32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------- weight trees


def test_quantize_llm_and_vit_int8_match_jax(tiny_q):
    """The port's quantize_llm_int8 / quantize_vit_int8 of the bridged fp32
    tree == the JAX quantized tree run op by op, leaf for leaf, bit for bit.
    (Under ``jax.jit`` XLA multiplies by the reciprocal of 127 instead of
    dividing, which moves some scales by one ulp; the port divides, as the
    JAX functions do when they run op by op.)"""
    _, jp, _, _ = tiny_q
    with jax.disable_jit():
        jq = _quantized_jax_tree(jp)
    tp = port_params(jp)
    tq = tq8.quantize_llm_int8(tp)
    tq["visual"] = tq8.quantize_vit_int8(tq["visual"])
    want, got = _leaves(jq), _torch_leaves(tq)
    assert set(got) == set(want)
    for name, w in want.items():
        assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name
        np.testing.assert_array_equal(npy(got[name]), w, err_msg=name)


def test_init_params_int8_is_the_quantized_init():
    """init_params(quantize_int8, quantize_vit_int8) quantizes each stack as
    it is drawn: the same leaves as quantizing the fp32 init of the same
    seed, and the JAX int8 tree's keys, shapes and dtypes."""
    cfg = tiny_cfg()
    pcfg = port_cfg(cfg)
    got = tparams.init_params(pcfg, seed=3, dtype=torch.float32, device="cpu",
                              quantize_int8=True, quantize_vit_int8=True)
    want = tq8.quantize_llm_int8(tparams.init_params(pcfg, seed=3, dtype=torch.float32,
                                                     device="cpu"))
    want["visual"] = tq8.quantize_vit_int8(want["visual"])
    got_l, want_l = _torch_leaves(got), _torch_leaves(want)
    assert set(got_l) == set(want_l)
    for name in want_l:
        assert torch.equal(got_l[name], want_l[name]), name
    jshape = jax.eval_shape(lambda: jparams._init_params_traced(cfg, 0, jnp.float32, True, True))
    jl = {
        ".".join(str(getattr(k, "key", k)) for k in path): (tuple(v.shape), str(v.dtype))
        for path, v in jax.tree_util.tree_flatten_with_path(jshape)[0]
    }
    tl = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got_l.items()}
    assert tl == jl


def test_weight_bridge_keeps_int8_leaves(tiny_q):
    """from_jax_params(dtype=bf16) casts the float leaves only: int8 weights
    stay int8 and the scales beside them fp32; norms (ViT ``ln*.scale``
    included) and biases become bf16."""
    _, _, jq, _ = tiny_q
    tb = tparams.from_jax_params(jax.tree.map(np.asarray, jq), dtype=torch.bfloat16)
    assert tb["layers"]["q"]["w"].dtype == torch.int8
    assert tb["layers"]["q"]["scale"].dtype == torch.float32
    assert tb["layers"]["q"]["b"].dtype == torch.bfloat16
    assert tb["embed_tokens"]["w"].dtype == torch.int8
    assert tb["embed_tokens"]["scale"].dtype == torch.float32
    assert tb["visual"]["blocks"]["ln1"]["scale"].dtype == torch.bfloat16
    assert tb["visual"]["blocks"]["qkv"]["scale"].dtype == torch.float32
    assert tb["visual"]["patch_embed"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(npy(tb["layers"]["q"]["w"]), np.asarray(jq["layers"]["q"]["w"]))


def test_model_stores_int8_linears_column_major(tiny_q):
    """int8 linear weights are held column-major (each [in, out] slice the
    transpose of a contiguous [out, in]) with their values unchanged; the
    int8 embedding stays row-major (read by rows)."""
    _, _, jq, model = tiny_q
    for name, w in (("layers.q", model.layers.q.w), ("lm_head", model.lm_head.w),
                    ("visual.blocks.fc1", model.visual.blocks.fc1.w),
                    ("visual.merger.fc2", model.visual.merger.fc2.w)):
        sl = w[0] if w.dim() == 3 else w
        assert w.dtype == torch.int8 and sl.stride() == (1, sl.shape[0]), name
    np.testing.assert_array_equal(npy(model.layers.q.w), np.asarray(jq["layers"]["q"]["w"]))
    np.testing.assert_array_equal(npy(model.lm_head.w), np.asarray(jq["lm_head"]["w"]))
    assert model.embed_tokens.w.is_contiguous()


def test_model_dtype_reads_a_float_leaf(tiny_q):
    _, _, _, model = tiny_q
    assert model.embed_tokens.w.dtype == torch.int8
    assert model.dtype == torch.float32 and model.visual.dtype == torch.float32
    assert model.int8 and model.visual.int8
    assert model.device.type == "cpu"


# ---------------------------------------------------------------- embed / head


@pytest.mark.parametrize("tied", [False, True])
def test_int8_embed_and_logits_match_jax(rng, tied):
    """int8 embedding rows times their scale; int8 LM head (weight-only), or
    for a tied model the per-row embedding scale as a per-logit scale:
    embed exact, logits atol 1e-5, against JAX."""
    cfg = tiny_cfg(tie_word_embeddings=tied)
    jq = jq8.quantize_llm_int8(jparams.init_params(cfg, seed=2, dtype=jnp.float32))
    model = Qwen2VLModel(port_cfg(cfg), port_params(jq))
    pcfg = port_cfg(cfg)
    ids = np.array([0, 7, 511, 3])
    np.testing.assert_array_equal(npy(ttext.embed(model, torch.from_numpy(ids))),
                                  np.asarray(jtext.embed(jq, jnp.asarray(ids))))
    h = rng.normal(size=(3, cfg.hidden_size)).astype(np.float32)
    np.testing.assert_allclose(npy(ttext.final_logits(model, pcfg, tt(h[0]))),
                               np.asarray(jtext.final_logits(jq, cfg, jnp.asarray(h[0]))),
                               atol=1e-5)
    np.testing.assert_allclose(npy(ttext.final_logits_batch(model, pcfg, tt(h))),
                               np.asarray(jtext.final_logits_batch(jq, cfg, jnp.asarray(h))),
                               atol=1e-5)


# ---------------------------------------------------------------- K1 int8


def _kv_int8(rng, *shape):
    return jq8.quantize_kv_block(jnp.asarray(rng.normal(size=shape).astype(np.float32)))


# (H, KV, S, budget, cache_len, valid_len), as the bf16 K1 cases
K1_INT8_CASES = [(4, 2, 16, 32, 0, 16), (4, 2, 16, 32, 13, 11), (6, 2, 24, 64, 64, 19)]


@pytest.mark.parametrize("prequant", [True, False])
@pytest.mark.parametrize("case", range(len(K1_INT8_CASES)))
def test_flash_prefill_int8_matches_jax_kernel(rng, case, prequant):
    """K1's int8-KV mode (plain twin on the CPU): int8 cache with scales,
    the chunk pre-quantized (``new_scales``) or quantized inside, against
    the JAX Pallas kernel (interpret); fp32, atol 1e-5. The int8 arm of
    ``chunk_prefill_attention`` (bf16 chunk) against JAX's; atol 1e-5."""
    h, kv, s, budget, cache_len, valid_len = K1_INT8_CASES[case]
    d = 16
    q = rng.normal(size=(h, s, d)).astype(np.float32)
    (kc, ks), (vc, vs) = _kv_int8(rng, kv, budget, d), _kv_int8(rng, kv, budget, d)
    kn, vn = (rng.normal(size=(kv, s, d)).astype(np.float32) for _ in range(2))
    (knq, kns), (vnq, vns) = jq8.quantize_kv_block(jnp.asarray(kn)), jq8.quantize_kv_block(
        jnp.asarray(vn))
    new = (knq, vnq, (kns, vns)) if prequant else (jnp.asarray(kn), jnp.asarray(vn), None)
    want = np.asarray(jflash(jnp.asarray(q), kc, vc, jnp.int32(cache_len), new[0], new[1],
                             jnp.int32(valid_len), k_scale=ks, v_scale=vs, new_scales=new[2]))
    tnew = (tt(new[0]), tt(new[1]), None if new[2] is None else (tt(kns), tt(vns)))
    cl, vl = torch.tensor(cache_len, dtype=torch.int32), torch.tensor(valid_len, dtype=torch.int32)
    n0 = flash_prefill.flash_prefill_attention_int8.launches
    got = flash_prefill.flash_prefill_attention(
        tt(q), tt(kc), tt(vc), cl, tnew[0], tnew[1], vl, tt(ks), tt(vs), tnew[2])
    assert flash_prefill.flash_prefill_attention_int8.launches == n0  # CPU: the plain twin
    np.testing.assert_allclose(npy(got), want, atol=1e-5)
    want_x = jattn.chunk_prefill_attention(jnp.asarray(q), kc, vc, jnp.int32(cache_len),
                                           jnp.asarray(kn), jnp.asarray(vn), jnp.int32(valid_len),
                                           k_scale=ks, v_scale=vs)
    got_x = tattn.chunk_prefill_attention(tt(q), tt(kc), tt(vc), cl, tt(kn), tt(vn), vl,
                                          tt(ks), tt(vs))
    np.testing.assert_allclose(npy(got_x), np.asarray(want_x), atol=1e-5)


@pytest.mark.parametrize("cache_len", [0, 7, 20])
def test_decode_appendfree_int8_matches_jax(rng, cache_len):
    """Sequential decode over an int8 cache, scales commuted; atol 1e-5."""
    h, kv, d, budget = 4, 2, 16, 20
    q = rng.normal(size=(h, 1, d)).astype(np.float32)
    (kc, ks), (vc, vs) = _kv_int8(rng, kv, budget, d), _kv_int8(rng, kv, budget, d)
    kn, vn = (rng.normal(size=(kv, 1, d)).astype(np.float32) for _ in range(2))
    want = jattn.decode_attention_appendfree(jnp.asarray(q), kc, vc, jnp.int32(cache_len),
                                             jnp.asarray(kn), jnp.asarray(vn), ks, vs)
    got = tattn.decode_attention_appendfree(tt(q), tt(kc), tt(vc), cache_len, tt(kn), tt(vn),
                                            tt(ks), tt(vs))
    np.testing.assert_allclose(npy(got), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------- K4 int8

# (B, KV, G, D, S, final_len, dec_start, gap_start, gap_filled): dec_start
# holes and a free slot; the non-power-of-two bucket S = 384
GAPPED_INT8_CASES = [
    (3, 2, 3, 8, 64, [10, 32, 0], [40, 44, 40], 40, 12),
    (2, 2, 3, 8, 384, [100, 300], [320, 336], 320, 40),
]


def _gapped_int8(rng, b, kv, g, d, s, lead=()):
    q = (rng.normal(size=(b, kv * g, d)) * 0.3).astype(np.float32)
    kc, ks = _kv_int8(rng, *lead, b, kv, s, d)
    vc, vs = _kv_int8(rng, *lead, b, kv, s, d)
    kn, vn = ((rng.normal(size=(b, kv, d)) * 0.3).astype(np.float32) for _ in range(2))
    return q, kc, ks, vc, vs, kn, vn


def test_decode_gapped_int8_plain_matches_jax_kernel(rng):
    """K4's int8-KV twin against the JAX kernel's stacked mode ([L, B, KV,
    S, D] int8, [L, B, KV, S] scales, ``layer``; interpret), every layer:
    acc, m, l atol 1e-5. Slot 2 has no live column: the empty state."""
    n_layers, b, kv, g, d, s = 2, 3, 2, 3, 8, 384
    _, kc, ks, vc, vs, _, _ = _gapped_int8(rng, b, kv, g, d, s, lead=(n_layers,))
    q4 = (rng.normal(size=(b, kv, g, d)) * 0.3).astype(np.float32)
    fl, ds, write_end = np.array([100, 300, 0], np.int32), np.array([320, 336, s], np.int32), 360
    for li in range(n_layers):
        jacc, jm, jl = jgapped(jnp.asarray(q4), kc, vc, jnp.asarray(fl), jnp.asarray(ds),
                               jnp.int32(write_end), ks, vs, layer=jnp.int32(li))
        n0 = decode_gapped.decode_gapped_flash_state_int8.launches
        acc, m, l = decode_gapped.decode_gapped_flash_state(
            tt(q4), tt(kc)[li], tt(vc)[li], tt(fl), tt(ds), write_end, tt(ks)[li], tt(vs)[li])
        assert decode_gapped.decode_gapped_flash_state_int8.launches == n0
        np.testing.assert_allclose(npy(acc), np.asarray(jacc), atol=1e-5)
        np.testing.assert_allclose(npy(m), np.asarray(jm), atol=1e-5)
        np.testing.assert_allclose(npy(l), np.asarray(jl), atol=1e-5, rtol=1e-6)
        assert (npy(m)[2] == decode_gapped.NEG_INF).all() and (npy(l)[2] == 0).all()


@pytest.mark.parametrize("case", range(len(GAPPED_INT8_CASES)))
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_attention_batch_gapped_int8_matches_jax(rng, case, impl):
    """Both port arms with an int8 cache against both JAX arms; fp32, atol
    2e-5 as the bf16 cases."""
    b, kv, g, d, s, fl, ds, gap_start, gap_filled = GAPPED_INT8_CASES[case]
    q, kc, ks, vc, vs, kn, vn = _gapped_int8(rng, b, kv, g, d, s)
    fl, ds = np.asarray(fl, np.int32), np.asarray(ds, np.int32)
    got = tattn.decode_attention_batch_gapped(
        tt(q), tt(kc), tt(vc), tt(fl), gap_start, gap_filled, tt(kn), tt(vn), tt(ks), tt(vs),
        dec_start=tt(ds), impl=impl,
    )
    for jimpl in ("xla", "pallas"):
        want = jattn.decode_attention_batch_gapped(
            jnp.asarray(q), kc, vc, jnp.asarray(fl), jnp.int32(gap_start), jnp.int32(gap_filled),
            jnp.asarray(kn), jnp.asarray(vn), ks, vs, dec_start=jnp.asarray(ds), impl=jimpl,
        )
        np.testing.assert_allclose(npy(got), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_attention_batch_gapped_int8_layer_index_matches_jax(rng, impl):
    """``layer`` indexes a stacked int8 cache and its stacked scale planes;
    atol 2e-5 against the JAX stacked-mode kernel call."""
    n_layers, b, kv, g, d, s = 2, 2, 2, 3, 8, 64
    q, kc, ks, vc, vs, kn, vn = _gapped_int8(rng, b, kv, g, d, s, lead=(n_layers,))
    fl, ds = np.array([10, 32], np.int32), np.array([40, 44], np.int32)
    for li in range(n_layers):
        want = jattn.decode_attention_batch_gapped(
            jnp.asarray(q), kc, vc, jnp.asarray(fl), jnp.int32(40), jnp.int32(12),
            jnp.asarray(kn), jnp.asarray(vn), ks, vs, dec_start=jnp.asarray(ds),
            layer=jnp.int32(li), impl="pallas",
        )
        got = tattn.decode_attention_batch_gapped(
            tt(q), tt(kc), tt(vc), tt(fl), 40, 12, tt(kn), tt(vn), tt(ks), tt(vs),
            dec_start=tt(ds), layer=li, impl=impl,
        )
        np.testing.assert_allclose(npy(got), np.asarray(want), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------- the int8 cache


@pytest.mark.parametrize("prequant", [False, True])
def test_append_blocks_int8_matches_jax(rng, prequant):
    """In-place appends into an int8 cache (quantized on the way in, or
    handed int8 blocks and scales) == the JAX functional appends, exactly."""
    l_, kvh, budget, hd, s = 2, 2, 24, 4, 8
    jkv = jcache.init_cache(l_, kvh, budget, hd, dtype=jnp.float32, quantized=True)
    tkv = tcache.init_cache(l_, kvh, budget, hd, dtype=torch.float32, device="cpu",
                            quantized=True)
    assert tkv.quantized and tkv.k.dtype == torch.int8
    for adv in (5, 8):
        k = rng.normal(size=(l_, kvh, s, hd)).astype(np.float32)
        v = rng.normal(size=(l_, kvh, s, hd)).astype(np.float32)
        pos = rng.integers(0, 99, size=(l_, 3, s)).astype(np.int32)
        if prequant:
            (kq, ks), (vq, vs) = jq8.quantize_kv_block(jnp.asarray(k)), jq8.quantize_kv_block(
                jnp.asarray(v))
            jkv = jcache.append_blocks(jkv, kq, vq, jnp.asarray(pos), jnp.int32(adv),
                                       k_scales=ks, v_scales=vs)
            tcache.append_blocks(tkv, tt(kq), tt(vq), tt(pos), adv, tt(ks), tt(vs))
        else:
            jkv = jcache.append_blocks(jkv, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                                       jnp.int32(adv))
            tcache.append_blocks(tkv, tt(k), tt(v), tt(pos), adv)
    for name in ("k", "v", "pos", "length", "k_scale", "v_scale"):
        np.testing.assert_array_equal(npy(getattr(tkv, name)), np.asarray(getattr(jkv, name)))


def _chunk_inputs(cfg, rng):
    d = cfg.hidden_size
    first = rng.normal(size=(8, d)).astype(np.float32) * 0.5
    second = rng.normal(size=(16, d)).astype(np.float32) * 0.5
    pos1 = np.broadcast_to(np.arange(8, dtype=np.int32), (3, 8)).copy()
    i = np.arange(16)
    pos2 = np.stack([8 + i // 4, 8 + (i % 4) // 2, 8 + i % 2]).astype(np.int32)
    keypatch = rng.random(16) < 0.25
    return first, second, pos1, pos2, keypatch


@pytest.mark.parametrize("w8a8", [False, True])
@pytest.mark.parametrize("compress,reforge", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_decoder_chunk_int8_cache_matches_jax(rng, compress, reforge, attn_impl, w8a8):
    """A text chunk into an empty int8 cache, then a ragged chunk (valid 13
    of 16, keep 9) over it, YaRN x4: the int8 cache's k and v equal to
    JAX's, its scales atol 1e-6, pos and length exact, hidden atol 1e-4.
    ``w8a8``: int8 weights with W8A8 linears (``act_quant``). The pallas
    arm quantizes the chunk once for K1 and the append, the xla arm at the
    append, as in JAX."""
    cfg = tiny_cfg(yarn_factor=4.0)
    jp = jparams.init_params(cfg, seed=1, dtype=jnp.float32)
    if w8a8:
        jp = jq8.quantize_llm_int8(jp)
    model = Qwen2VLModel(port_cfg(cfg), port_params(jp))
    first, second, pos1, pos2, keypatch = _chunk_inputs(cfg, rng)
    l_, kvh, hd, budget = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim, 32

    jkv = jcache.init_cache(l_, kvh, budget, hd, dtype=jnp.float32, quantized=True)
    _, jkv = jtext.decoder_chunk(
        jp, cfg, jkv, jnp.asarray(first), jnp.asarray(pos1), jnp.int32(8), jnp.zeros(8, bool),
        jnp.int32(8), compress=False, reforge=reforge, attn_impl=attn_impl, act_quant=w8a8,
    )
    jh, jkv = jtext.decoder_chunk(
        jp, cfg, jkv, jnp.asarray(second), jnp.asarray(pos2), jnp.int32(13),
        jnp.asarray(keypatch), jnp.int32(9), compress=compress, reforge=reforge,
        attn_impl=attn_impl, act_quant=w8a8,
    )
    pcfg = port_cfg(cfg)
    tkv = tcache.init_cache(l_, kvh, budget, hd, dtype=torch.float32, device="cpu",
                            quantized=True)
    _, tkv = ttext.decoder_chunk(
        model, pcfg, tkv, tt(first), tt(pos1), 8, torch.zeros(8, dtype=torch.bool), 8,
        compress=False, reforge=reforge, attn_impl=attn_impl, act_quant=w8a8,
    )
    th, tkv = ttext.decoder_chunk(
        model, pcfg, tkv, tt(second), tt(pos2), 13, tt(keypatch), 9,
        compress=compress, reforge=reforge, attn_impl=attn_impl, act_quant=w8a8,
    )
    np.testing.assert_allclose(npy(th), np.asarray(jh), atol=1e-4)
    np.testing.assert_array_equal(npy(tkv.k), np.asarray(jkv.k))
    np.testing.assert_array_equal(npy(tkv.v), np.asarray(jkv.v))
    np.testing.assert_allclose(npy(tkv.k_scale), np.asarray(jkv.k_scale), atol=1e-6)
    np.testing.assert_allclose(npy(tkv.v_scale), np.asarray(jkv.v_scale), atol=1e-6)
    np.testing.assert_array_equal(npy(tkv.pos), np.asarray(jkv.pos))
    assert int(tkv.length) == int(jkv.length) == (8 + (9 if compress else 13))


# ---------------------------------------------------------------- W8A8 vision


@pytest.mark.parametrize("attn_impl", ["pallas", "xla"])
def test_vision_tower_w8a8_matches_jax(tiny_q, rng, attn_impl):
    """int8 block and merger linears with W8A8 (the qkv scale reordered
    head-major with its columns) against JAX's vision_tower(act_quant);
    fp32, atol 1e-4 as the float tower."""
    cfg, _, jq, model = tiny_q
    t, h, w = 2, 4, 8
    patches = rng.normal(size=(t * h * w, cfg.vision.patch_input_dim)).astype(np.float32)
    want = jvision.vision_tower(jq["visual"], cfg.vision, jnp.asarray(patches), t, h, w,
                                act_quant=True)
    got = model.visual(tt(patches), t, h, w, attn_impl, act_quant=True)
    np.testing.assert_allclose(npy(got), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------- whole requests

RETAKE = {
    "scaling_factor": 4,
    "longvideo_kwargs": {
        "chunked_prefill_frames": 2,
        "frame_chunk_size": 4,
        "visual_compression": True,
        "visual_compression_kwargs": {
            "compression_ratio": 1.0, "compression_method": "Keyframe",
            "patch_sync": False, "return_keyframe_mask": True,
        },
        "kvcache_compression": True,
        "kvcache_compression_kwargs": {
            "dynamic_compression_ratio": True, "compression_method": "pivotkv",
            "pos_embed_reforge": True, "max_input_length": 24,
        },
    },
}
# (weights, extra config): the int8 KV cache on fp32 weights; weight-only
# int8; W8A8; and the serving config's W8A8 + int8 KV
GENERATE_CASES = {
    "kv_int8": ("float", {"kv_cache_dtype": "int8"}),
    "int8": ("int8", {"quantization": "int8"}),
    "w8a8": ("int8", {"quantization": "w8a8"}),
    "w8a8_kv_int8": ("int8", {"quantization": "w8a8", "kv_cache_dtype": "int8"}),
}


@pytest.mark.parametrize("conf,attn_impl", [
    ("kv_int8", "pallas"), ("kv_int8", "xla"), ("int8", "pallas"), ("w8a8", "pallas"),
    ("w8a8", "xla"), ("w8a8_kv_int8", "pallas"),
])
def test_generate_int8_matches_jax_engine(tiny_q, rng, conf, attn_impl):
    """The whole ReTaKe request (ViT, DPSelect mask, chunked prefill, PivotKV
    with reforge, YaRN, greedy decode) under the int8 options: the JAX
    engine's tokens exactly, the same cache plan, and the int8 cache when
    asked for."""
    cfg, jp, jq, model_q = tiny_q
    weights, extra = GENERATE_CASES[conf]
    jtree = jq if weights == "int8" else jp
    model = model_q if weights == "int8" else Qwen2VLModel(port_cfg(cfg), port_params(jp))
    rd = dict(RETAKE, attn_implementation=attn_impl, **extra)
    ids, patches, grid = video_request(cfg, rng, grid_t=8)
    want = JaxEngine(cfg, jtree, JaxRetakeConfig.from_dict(rd)).generate(
        ids, patches, grid, max_new_tokens=8)
    eng = Qwen2VLEngine(port_cfg(cfg), model, RetakeConfig.from_dict(rd), device="cpu")
    assert eng.act_quant == (extra.get("quantization") == "w8a8")
    got = eng.generate(ids, patches, grid, max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.cache_len == want.cache_len == got.cache_fill
    assert got.cache.quantized == ("kv_cache_dtype" in extra)


def test_generate_batch_int8_kv_matches_jax(tiny_q):
    """Sequential prefill into int8 caches, one batched decode over the
    gap-layout int8 cache and its scale planes: the JAX engine's
    generate_batch tokens exactly (two video lengths, a text-only request)."""
    cfg, jp, _, _ = tiny_q
    model = Qwen2VLModel(port_cfg(cfg), port_params(jp))
    rd = {"kv_cache_dtype": "int8",
          "longvideo_kwargs": {"chunked_prefill_frames": 2, "frame_chunk_size": 2,
                               "kvcache_compression": True,
                               "kvcache_compression_kwargs": {"compression_ratio": 0.6,
                                                              "pos_embed_reforge": True}}}
    rng = np.random.default_rng(5)
    reqs = [dict(zip(("input_ids", "pixel_values_videos", "video_grid_thw"),
                     video_request(cfg, rng, grid_t=t, prompt_len=p))) for t, p in ((4, 4), (2, 6))]
    reqs.append(dict(input_ids=rng.integers(10, 500, size=9).astype(np.int64)))
    want = JaxEngine(cfg, jp, JaxRetakeConfig.from_dict(rd)).generate_batch(
        [dict(r) for r in reqs], max_new_tokens=6)
    got = Qwen2VLEngine(port_cfg(cfg), model, RetakeConfig.from_dict(rd), device="cpu"
                        ).generate_batch([dict(r) for r in reqs], max_new_tokens=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_prefill_state_trims_int8_scales(tiny_q, monkeypatch):
    """A prefill-only int8 cache is trimmed to its decode bucket with its
    scales (budget buckets shrunk to 16 so the bucket is below the budget)."""
    from retake_tpu_torch.runtime import engine as tengine

    cfg, jp, _, _ = tiny_q
    monkeypatch.setattr(tengine, "BUDGET_BUCKET", 16)
    model = Qwen2VLModel(port_cfg(cfg), port_params(jp))
    rd = {"kv_cache_dtype": "int8",
          "longvideo_kwargs": {"chunked_prefill_frames": 2, "frame_chunk_size": 2}}
    req = video_request(cfg, np.random.default_rng(4), grid_t=4, prompt_len=30)
    st = Qwen2VLEngine(port_cfg(cfg), model, RetakeConfig.from_dict(rd), device="cpu").generate(
        *req, max_new_tokens=5, _prefill_only=True)
    c = st.cache
    assert c.quantized and c.budget == st.attn_need
    assert c.k_scale.shape == c.k.shape[:3] and c.v_scale.shape == c.k.shape[:3]
    assert (c.k_scale[:, :, : st.final_len] > 0).all()
    assert dataclasses.is_dataclass(c)
