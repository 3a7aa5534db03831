"""Tensor parallelism in the port (``retake_tpu_torch/parallel``) against the
JAX package's GSPMD mesh (``retake_tpu/parallel/mesh.py``, the engines'
``cache_sharding=``) on the CPU, fp32, tiny configs, same numpy weights.

tp = 2 runs as two threads of this process, each a rank with its own
``ProcessGroupGloo`` over one ``HashStore`` (``run_ranks``); every thread
rank has ``check`` on, so an engine request whose replicated values (vision
features, keypatch mask, cache positions, logits, tokens) differ across the
ranks raises. Two tests run real processes joined through ``make_mesh``
(tp = 2, and dp = 2 x tp = 2). The JAX references run on the 8-device virtual CPU mesh of
tests/conftest.py, at tp = 2 (``jax.set_mesh``) and unsharded.
"""

import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from retake_tpu.models.llava_onevision import params as jlparams
from retake_tpu.models.llava_onevision.config import (
    LlavaOnevisionConfig as JLlavaConfig,
    SiglipVisionConfig as JSiglipConfig,
)
from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu.models.qwen2_vl import text as jtext
from retake_tpu.models.qwen2_vl.config import Qwen2VisionConfig as JVisionConfig
from retake_tpu.models.qwen2_vl.config import Qwen2VLConfig as JQwenConfig
from retake_tpu.ops import quantization as jq8
from retake_tpu.parallel import mesh as jmesh
from retake_tpu.runtime import cache as jcache
from retake_tpu.runtime import engine as jengine_mod
from retake_tpu.runtime import llava_engine as jllava_mod
from retake_tpu.runtime.engine import Qwen2VLEngine as JaxEngine
from retake_tpu.runtime.llava_engine import LlavaOnevisionEngine as JaxLlavaEngine
from retake_tpu.runtime.serve import ContinuousServer as JaxServer
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.models.llava_onevision import config as tlconfig
from retake_tpu_torch.models.llava_onevision.model import LlavaOnevisionModel
from retake_tpu_torch.models.qwen2_vl import text as ttext
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.ops import quantization as tq8
from retake_tpu_torch.parallel import TensorParallel, kv_slice, shard_params, spec_for_path
from retake_tpu_torch.parallel.mesh import shard_leaf
from retake_tpu_torch.runtime import cache as tcache
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.runtime.llava_engine import LlavaOnevisionEngine
from retake_tpu_torch.runtime.serve import ContinuousServer
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import npy, port_cfg, port_params, tiny_cfg, tt, video_request

JOIN_S = 120.0  # every rank thread and process is joined within this

# the full ReTaKe request of tests/test_torch_quant.py: DPSelect mask,
# chunked prefill, PivotKV with reforge at a dynamic ratio, YaRN x4
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
# the serving config of tests/test_torch_serve.py
SERVE_RT = {"longvideo_kwargs": {
    "chunked_prefill_frames": 2, "frame_chunk_size": 2, "kvcache_compression": True,
    "kvcache_compression_kwargs": {"compression_ratio": 0.6, "pos_embed_reforge": True}}}
W8A8_KV8 = {"quantization": "w8a8", "kv_cache_dtype": "int8"}
LLAVA_RT = {"longvideo_kwargs": {
    "chunked_prefill_frames": 2, "frame_chunk_size": 4, "visual_compression": True,
    "visual_compression_kwargs": {"compression_ratio": 0.5, "compression_method": "Keyframe",
                                  "patch_sync": False, "return_keyframe_mask": True},
    "kvcache_compression": True,
    "kvcache_compression_kwargs": {"dynamic_compression_ratio": True,
                                   "compression_method": "pivotkv", "pos_embed_reforge": True,
                                   "max_input_length": 16}}}


# ---------------------------------------------------------------- rank threads


def thread_groups(size: int, prefix: str = "tp"):
    """``size`` group factories over one store: ``make(rank)`` builds that
    rank's ``ProcessGroupGloo`` (call it on the rank's own thread)."""
    store = dist.HashStore()

    def make(rank):
        return dist.ProcessGroupGloo(dist.PrefixStore(prefix, store), rank, size,
                                     datetime.timedelta(seconds=JOIN_S / 2))
    return make


def run_ranks(fn, size: int = 2, layout=None):
    """``fn(tp)`` on ``size`` threads, each a TP rank with ``check`` on;
    returns the results in rank order and raises the first rank's error.
    ``layout``: per thread (group factory, rank in it), for dp x tp."""
    if layout is None:
        make = thread_groups(size)
        layout = [(make, r) for r in range(size)]
    results, errors = [None] * len(layout), [None] * len(layout)

    def body(i):
        try:
            make, rank = layout[i]
            tp = TensorParallel(make(rank))
            tp.check = True
            with torch.no_grad():
                results[i] = fn(tp)
        except BaseException as e:  # handed to the test thread below
            errors[i] = e

    threads = [threading.Thread(target=body, args=(i,), daemon=True) for i in range(len(layout))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a rank thread did not finish"
    for e in errors:
        if e is not None:
            raise e
    return results


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one intra-op thread, on the test thread as on
    the rank threads (the test thread's thread pool also competes with
    JAX's for the cores); restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """The tiny Qwen2-VL (4/2 heads) fp32 JAX tree, its int8 tree (LLM and
    ViT), both as port trees, and the JAX tp = 2 mesh."""
    cfg = tiny_cfg()
    jp = jparams.init_params(cfg, seed=0, dtype=jnp.float32)
    jq = jq8.quantize_llm_int8(jp)
    jq["visual"] = jq8.quantize_vit_int8(jq["visual"])
    return types.SimpleNamespace(cfg=cfg, pcfg=port_cfg(cfg), jp=jp, jq=jq, pp=port_params(jp),
                                 pq=port_params(jq), mesh=jmesh.make_mesh(dp=1, tp=2))


def jax_tp_engine(t, tree, rd):
    return JaxEngine(t.cfg, jmesh.shard_params(tree, t.mesh), JaxRetakeConfig.from_dict(rd),
                     cache_sharding=jmesh.cache_shardings(t.mesh))


def port_engine(t, tree, rd, tp=None):
    model = Qwen2VLModel(t.pcfg, shard_params(tree, tp), tp)
    return Qwen2VLEngine(t.pcfg, model, RetakeConfig.from_dict(rd), device="cpu", tp=tp)


def _req(ids, patches, grid, **kw):
    return dict(input_ids=ids, pixel_values_videos=patches, video_grid_thw=grid, **kw)


# ---------------------------------------------------------------- the rules


def _jax_7b():
    return JQwenConfig()


def _jax_2b():
    return JQwenConfig(vocab_size=151936, hidden_size=1536, intermediate_size=8960,
                       num_attention_heads=12, num_key_value_heads=2, tie_word_embeddings=True,
                       vision=JVisionConfig(hidden_size=1536))


RULE_CONFIGS = {"tiny": lambda: tiny_cfg(), "2b": _jax_2b, "7b": _jax_7b,
                "llava": lambda: JLlavaConfig()}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name", list(RULE_CONFIGS))
def test_rule_table_matches_jax(name, int8):
    """``spec_for_path`` is the JAX ``_spec_for_path`` for every leaf of the
    bf16 and int8 trees of the tiny model, Qwen2-VL-2B / 7B and
    LLaVA-Video-7B (shapes only: ``jax.eval_shape``), and ``shard_params``
    cuts each leaf to the share that spec gives (meta tensors)."""
    cfg = RULE_CONFIGS[name]()
    if name == "llava":
        init = lambda: jlparams.init_params(cfg, 0, quantize_int8=int8,  # noqa: E731
                                            quantize_vision_int8=int8)
    else:
        init = lambda: jparams.init_params(cfg, 0, quantize_int8=int8,  # noqa: E731
                                           quantize_vit_int8=int8)
    shapes = jax.eval_shape(init)
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    tree, want = {}, {}
    for path, leaf in leaves:
        names = tuple(p.key for p in path)
        jspec = tuple(jmesh._spec_for_path(path, leaf))
        assert spec_for_path(names) == jspec, (names, jspec)
        node = tree
        for k in names[:-1]:
            node = node.setdefault(k, {})
        dtype = {"int8": torch.int8, "bfloat16": torch.bfloat16}.get(str(leaf.dtype), torch.float32)
        node[names[-1]] = torch.empty(leaf.shape, dtype=dtype, device="meta")
        local = list(leaf.shape)
        if "tp" in jspec:
            local[jspec.index("tp")] //= 2
        want[names] = tuple(local)
    assert any("tp" in spec_for_path(n) for n in want)
    for rank in (0, 1):
        got = shard_params(tree, types.SimpleNamespace(rank=rank, size=2))

        def walk(node, names=()):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, names + (k,))
                else:
                    assert tuple(v.shape) == want[names + (k,)], (names + (k,), v.shape)
        walk(got)


def test_shard_leaf_takes_the_rank_share_as_a_copy():
    """Columns / rows / vocabulary of the rank, contiguous and not a view
    of the whole leaf; a replicated leaf is the same tensor."""
    w = torch.arange(2 * 4 * 6, dtype=torch.float32).reshape(2, 4, 6)
    for rank in (0, 1):
        h = types.SimpleNamespace(rank=rank, size=2)
        cols = shard_leaf(w, (None, None, "tp"), h)
        rows = shard_leaf(w, (None, "tp", None), h)
        assert torch.equal(cols, w[:, :, 3 * rank : 3 * rank + 3]) and cols.is_contiguous()
        assert torch.equal(rows, w[:, 2 * rank : 2 * rank + 2])
        assert cols.untyped_storage().data_ptr() != w.untyped_storage().data_ptr()
        assert shard_leaf(w, (), h) is w
    with pytest.raises(ValueError, match="does not split"):
        shard_leaf(w, (None, None, "tp"), types.SimpleNamespace(rank=0, size=4))


# ---------------------------------------------------------------- one chunk


def _chunk_inputs(cfg, rng, s=16):
    embeds = (rng.normal(size=(s, cfg.hidden_size)) * 0.1).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, s)).copy()
    return embeds, pos


def _port_chunk(model, cfg, embeds, pos, attn_impl, act_quant=False, quantized=False, budget=64):
    kv = tcache.init_cache(cfg.num_hidden_layers, model.num_kv_heads, budget, cfg.head_dim,
                           dtype=torch.float32, device="cpu", quantized=quantized)
    s = embeds.shape[0]
    hidden, kv = ttext.decoder_chunk(
        model, cfg, kv, tt(embeds), tt(pos), s, torch.zeros(s, dtype=torch.bool), s // 2,
        compress=True, reforge=True, attn_impl=attn_impl, act_quant=act_quant)
    return hidden, kv


@pytest.fixture(scope="module")
def chunk_refs(tiny):
    """One compressing, reforging chunk (test_parallel.py's) through the
    JAX decoder unsharded and at tp = 2."""
    cfg = tiny.cfg
    embeds, pos = _chunk_inputs(cfg, np.random.default_rng(0))

    def run(p):
        kv = jcache.init_cache(cfg.num_hidden_layers, cfg.num_key_value_heads, 64, cfg.head_dim,
                               dtype=jnp.float32)
        s = embeds.shape[0]
        return jtext.decoder_chunk(p, cfg, kv, jnp.asarray(embeds), jnp.asarray(pos),
                                   jnp.int32(s), jnp.zeros(s, bool), jnp.int32(s // 2),
                                   compress=True, reforge=True)

    ref_h, ref_kv = jax.jit(run)(tiny.jp)
    with jax.set_mesh(tiny.mesh):
        tp_h, tp_kv = jax.jit(run)(jmesh.shard_params(tiny.jp, tiny.mesh))
    return embeds, pos, [(np.asarray(ref_h), np.asarray(ref_kv.k)),
                         (np.asarray(tp_h), np.asarray(tp_kv.k))]


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_decoder_chunk_tp_matches_jax(tiny, chunk_refs, attn_impl):
    """The chunk at tp = 2 (each rank its heads; under "pallas" K2's plain
    twin and the all-reduced head sum, under "xla" the plain scores'):
    hidden and each rank's cache heads within 1e-4 of the JAX tp = 2 run
    and of the unsharded one, the same length, and the positions (PivotKV's
    choice, reforged) the same on both ranks."""
    cfg, pcfg = tiny.cfg, tiny.pcfg
    embeds, pos, refs = chunk_refs

    def rank(tp):
        model = Qwen2VLModel(pcfg, shard_params(tiny.pp, tp), tp)
        hidden, kv = _port_chunk(model, pcfg, embeds, pos, attn_impl)
        return npy(hidden), npy(kv.k), npy(kv.pos), int(kv.length), tp.calls

    out = run_ranks(rank)
    for r, (hidden, k, pos_r, length, calls) in enumerate(out):
        heads = kv_slice(cfg.num_key_value_heads, types.SimpleNamespace(rank=r, size=2))
        for ref_h, ref_k in refs:
            np.testing.assert_allclose(hidden, ref_h, atol=1e-4)
            np.testing.assert_allclose(k, ref_k[:, heads], atol=1e-4)
        assert length == embeds.shape[0] // 2
        # per layer: o, down and the PivotKV head sum
        assert calls == 3 * cfg.num_hidden_layers
        np.testing.assert_array_equal(pos_r, out[0][2])


def test_decoder_chunk_tp_w8a8_int8_cache_matches_tp1(tiny):
    """W8A8 linears and the int8 cache at tp = 2: the row-parallel linears
    are exact, so hidden and each rank's int8 cache heads and scales equal
    the unsharded port's up to the order of the attention's head sums."""
    pcfg = tiny.pcfg
    embeds, pos = _chunk_inputs(tiny.cfg, np.random.default_rng(1))
    model1 = Qwen2VLModel(pcfg, tiny.pq)
    ref_h, ref_kv = _port_chunk(model1, pcfg, embeds, pos, "pallas", True, True)

    def rank(tp):
        model = Qwen2VLModel(pcfg, shard_params(tiny.pq, tp), tp)
        h, kv = _port_chunk(model, pcfg, embeds, pos, "pallas", True, True)
        return npy(h), kv, kv_slice(pcfg.num_key_value_heads, tp)

    for h, kv, heads in run_ranks(rank):
        np.testing.assert_allclose(h, npy(ref_h), atol=1e-4)
        np.testing.assert_array_equal(npy(kv.pos), npy(ref_kv.pos))
        np.testing.assert_allclose(npy(kv.k_scale), npy(ref_kv.k_scale)[:, heads], rtol=1e-5)
        assert np.abs(npy(kv.k).astype(int) - npy(ref_kv.k)[:, heads].astype(int)).max() <= 1


# ---------------------------------------------------------------- row-parallel linears


@pytest.mark.parametrize("rows,k,n", [(7, 64, 48), (33, 128, 64), (1, 256, 40)])
def test_row_parallel_w8a8_linear_is_bit_identical(rows, k, n):
    """``qlinear`` of a row-parallel linear (``tp=``): W8A8 (absmax
    all-reduced with MAX, int32 accumulators summed) equals the unsharded
    ``qlinear`` bit for bit; the
    weight-only and float forms sum rounded partials: within 1e-5."""
    rng = np.random.default_rng(rows)
    x = torch.from_numpy((rng.normal(size=(rows, k)) * 3).astype(np.float32))
    x[0, :8] *= 40  # one row's absmax on the first rank's half only
    w = torch.from_numpy((rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32))
    p8 = tq8.quantize_weight(w)
    want8 = tq8.qlinear(x, p8, act_int8=True)
    want_wo, want_f = tq8.qlinear(x, p8), tq8.qlinear(x, {"w": w})

    def rank(tp):
        half = slice(tp.rank * k // 2, (tp.rank + 1) * k // 2)
        xs = x[:, half].contiguous()
        p8r = {"w": p8["w"][half].contiguous(), "scale": p8["scale"]}
        return (tq8.qlinear(xs, p8r, act_int8=True, tp=tp), tq8.qlinear(xs, p8r, tp=tp),
                tq8.qlinear(xs, {"w": w[half].contiguous()}, tp=tp))

    for got8, got_wo, got_f in run_ranks(rank):
        assert torch.equal(got8, want8)
        torch.testing.assert_close(got_wo, want_wo, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(got_f, want_f, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- vision towers


def test_vit_frame_sharded_matches_jax(tiny):
    """``run_vision`` at tp = 2: each rank runs its frames of every chunk
    (one all-gather a chunk) and holds the whole features, within 2e-4 of
    JAX ``_vit_chunk_tp`` and of the tp = 1 port; a chunk of an odd frame
    count runs whole on each rank (no collective)."""
    cfg = tiny.cfg
    rng = np.random.default_rng(2)
    grid_t, h, w = 4, 4, 4
    patches = (rng.normal(size=(grid_t * h * w, cfg.vision.patch_input_dim)) * 0.1
               ).astype(np.float32)
    want = np.asarray(jengine_mod._vit_chunk_tp(
        tiny.jp["visual"], cfg, jnp.asarray(patches), grid_t, h, w, False, tiny.mesh))
    odd = patches[: 3 * h * w]
    rd = {"longvideo_kwargs": {"frame_chunk_size": 2, "chunked_prefill_frames": 2}}
    one = port_engine(tiny, tiny.pp, {})

    def rank(tp):
        eng = port_engine(tiny, tiny.pp, rd, tp)
        chunked = npy(eng.run_vision(patches, (grid_t, h, w)))
        calls = tp.calls
        whole = npy(port_engine(tiny, tiny.pp, {}, tp).run_vision(odd, (3, h, w)))
        return chunked, calls, whole, tp.calls - calls

    for chunked, calls, whole, odd_calls in run_ranks(rank):
        np.testing.assert_allclose(chunked, want, atol=2e-4)
        assert calls == 2 and odd_calls == 0
        np.testing.assert_allclose(whole, npy(one.run_vision(odd, (3, h, w))), atol=1e-6)


@pytest.fixture(scope="module")
def tiny_llava():
    """The tiny LLaVA of tests/test_parallel.py (4/2 text heads, SigLIP 2 x
    32) from the JAX init, fp32, in both packages, and the JAX mesh."""
    text = JQwenConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                       max_position_embeddings=4096, rope_theta=10000.0,
                       tie_word_embeddings=False, bos_token_id=0, eos_token_id=1,
                       mrope_section=None)
    cfg = JLlavaConfig(text=text, vision=JSiglipConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
        image_size=16, patch_size=4), image_token_id=5, video_token_id=6)
    jp = jlparams.init_params(cfg, seed=3, dtype=jnp.float32)
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["text"] = port_cfg(cfg.text)
    d["vision"] = tlconfig.SiglipVisionConfig(**dataclasses.asdict(cfg.vision))
    return types.SimpleNamespace(cfg=cfg, pcfg=tlconfig.LlavaOnevisionConfig(**d), jp=jp,
                                 pp=port_params(jp), mesh=jmesh.make_mesh(dp=1, tp=2))


def test_siglip_frame_sharded_matches_jax(tiny_llava):
    """SigLIP at tp = 2 (``run_vision``): within 2e-4 of JAX
    ``_siglip_chunk_tp``, one all-gather a 4-frame chunk."""
    t = tiny_llava
    frames = np.random.default_rng(4).integers(0, 255, size=(4, 16, 16, 3), dtype=np.uint8)
    want = np.asarray(jllava_mod._siglip_chunk_tp(
        t.jp["vision_tower"], t.cfg.vision, jnp.asarray(frames), False, t.mesh))

    def rank(tp):
        eng = LlavaOnevisionEngine(t.pcfg, shard_params(t.pp, tp), RetakeConfig.from_dict({}),
                                   device="cpu", tp=tp)
        return npy(eng.run_vision(frames)), tp.calls

    for got, calls in run_ranks(rank):
        np.testing.assert_allclose(got, want, atol=2e-4)
        assert calls == 1


# ---------------------------------------------------------------- whole requests


SERVE_KW = dict(batch_slots=2, segment_steps=3, max_new_tokens=7, gap_capacity=6)
ARRIVALS = [0.0, 0.0, 0.3]


@pytest.fixture(scope="module")
def requests_tp(tiny):
    """Three requests (8, 4 and 2 frames) and the JAX tp = 2 references:
    ``generate`` of the first in fp32 under RETAKE, and under the serving
    config (RETAKE with W8A8 + int8 KV) its ``generate``, ``generate_batch``
    of the first two and ``ContinuousServer.run`` of all three with
    staggered arrivals and forced compactions (one engine, so the JAX
    compiles are shared)."""
    rng = np.random.default_rng(3)
    reqs = [_req(*video_request(tiny.cfg, rng, grid_t=t, prompt_len=4 + i))
            for i, t in enumerate((8, 4, 2))]
    serving = dict(RETAKE, **W8A8_KV8)
    with jax.set_mesh(tiny.mesh):
        want = {"float": jax_tp_engine(tiny, tiny.jp, RETAKE).generate(**reqs[0], max_new_tokens=8)}
        eng = jax_tp_engine(tiny, tiny.jq, serving)
        want["int8"] = eng.generate(**reqs[0], max_new_tokens=8)
        want["batch"] = eng.generate_batch([dict(r) for r in reqs[:2]], max_new_tokens=6)
        want["server"] = JaxServer(eng, **SERVE_KW).run([dict(r) for r in reqs],
                                                          arrival_times=ARRIVALS)
    return reqs, serving, want


@pytest.mark.parametrize("weights", ["float", "int8"])
def test_generate_tp_matches_jax_and_tp1(tiny, requests_tp, weights):
    """A whole ReTaKe request (ViT frame-sharded, DPSelect mask, chunked
    prefill with PivotKV and reforge, YaRN, greedy decode) at tp = 2, in
    fp32 and in the serving config (W8A8 + int8 KV): the JAX tp = 2
    engine's tokens and the port's tp = 1 tokens exactly, the same plan,
    each rank's cache its KV head; the ranks' replicated values equal
    (``check``)."""
    reqs, serving, want = requests_tp
    tree, rd = (tiny.pp, RETAKE) if weights == "float" else (tiny.pq, serving)
    want = want[weights]
    one = port_engine(tiny, tree, rd).generate(**reqs[0], max_new_tokens=8)
    np.testing.assert_array_equal(one.tokens, want.tokens)

    def rank(tp):
        return port_engine(tiny, tree, rd, tp).generate(**reqs[0], max_new_tokens=8)

    for got in run_ranks(rank):
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert got.cache_len == want.cache_len == got.cache_fill
        assert got.cache.k.shape[1] == 1 and got.cache.quantized == (weights == "int8")
        np.testing.assert_allclose(got.first_logits, one.first_logits, atol=1e-4)


def test_generate_batch_w8a8_int8_kv_tp(tiny, requests_tp):
    """``generate_batch`` under W8A8 + int8 KV at tp = 2 (the gap-layout
    cache and scale planes hold each rank's KV head): the JAX tp = 2
    engine's tokens and the port's tp = 1 tokens."""
    reqs, serving, want = requests_tp
    one = port_engine(tiny, tiny.pq, serving).generate_batch([dict(r) for r in reqs[:2]],
                                                             max_new_tokens=6)

    def rank(tp):
        return port_engine(tiny, tiny.pq, serving, tp).generate_batch(
            [dict(r) for r in reqs[:2]], max_new_tokens=6)

    for got in run_ranks(rank):
        for g, w, o in zip(got, want["batch"], one):
            np.testing.assert_array_equal(g.tokens, w.tokens)
            np.testing.assert_array_equal(g.tokens, o.tokens)


def test_server_tp_with_arrivals_matches_jax(tiny, requests_tp):
    """``ContinuousServer.run`` at tp = 2 under W8A8 + int8 KV with
    staggered arrivals and forced compactions: rank 0 reads the clock and
    broadcasts each admission; the tokens equal the JAX tp = 2 server's and
    the port's tp = 1 server's, and ``on_tokens`` runs on rank 0 only."""
    reqs, serving, want = requests_tp
    one = ContinuousServer(port_engine(tiny, tiny.pq, serving), **SERVE_KW).run(
        [dict(r) for r in reqs], arrival_times=ARRIVALS)

    def rank(tp):
        streamed = []
        server = ContinuousServer(port_engine(tiny, tiny.pq, serving, tp), **SERVE_KW)
        res = server.run([dict(r) for r in reqs], arrival_times=ARRIVALS,
                         on_tokens=lambda rid, toks: streamed.append(rid))
        return res, streamed, server.stats["compactions"]

    (r0, s0, c0), (r1, s1, c1) = run_ranks(rank)
    for a, b, w, o in zip(r0, r1, want["server"], one):
        np.testing.assert_array_equal(a.tokens, w.tokens)
        np.testing.assert_array_equal(b.tokens, w.tokens)
        np.testing.assert_array_equal(a.tokens, o.tokens)
    assert s0 and not s1 and c0 == c1 >= 1


# tests/test_torch_reuse.py's prefix config (DPSelect dropping frames,
# PivotKV with reforge) in the serving config
PREFIX_RT = dict(W8A8_KV8, longvideo_kwargs={
    "frame_chunk_size": 4, "chunked_prefill_frames": 2, "visual_compression": True,
    "visual_compression_kwargs": {"compression_ratio": 0.5, "return_keyframe_mask": True},
    "kvcache_compression": True,
    "kvcache_compression_kwargs": {"compression_method": "pivotkv", "pos_embed_reforge": True,
                                   "compression_ratio": 0.5}})
PREFIX_SERVE_KW = dict(SERVE_KW, max_new_tokens=6, prefix_cache_slots=1, vision_cache_slots=1)


def _prefix_request(cfg, rng, question, grid_t=4):
    n_vid = grid_t * 16 // cfg.vision.spatial_merge_size**2
    ids = np.array([10, 11, 12, cfg.vision_start_token_id] + [cfg.video_token_id] * n_vid
                   + [cfg.vision_end_token_id] + list(question), dtype=np.int64)
    patches = rng.normal(size=(grid_t * 16, cfg.vision.patch_input_dim)).astype(np.float32)
    return ids, patches, np.array([[grid_t, 4, 4]])


def _reuse_run(eng, ids1, ids2, patches, grid):
    """``encode_prefix`` of question 1, both questions through the prefix,
    question 2 over ``encode_video``'s features; tokens and the prefix."""
    prefix = eng.encode_prefix(ids1, patches, grid, max_new_tokens=6)
    toks = [eng.generate(i, prefix=prefix, max_new_tokens=6).tokens for i in (ids1, ids2)]
    feats = eng.encode_video(patches, grid)
    toks.append(eng.generate(ids2, video_features=feats, max_new_tokens=6).tokens)
    return [np.asarray(t) for t in toks], prefix


def test_prefix_and_video_features_reuse_tp(tiny):
    """``encode_prefix`` -> ``generate(prefix=)`` (each use forks the rank's
    cache shard) and ``generate(video_features=)`` at tp = 2 under W8A8 +
    int8 KV: the JAX tp = 2 engine's tokens and the port's tp = 1 tokens,
    the prefix holding the rank's KV head and scales, and the ranks'
    replicated values (features, cache positions) equal (``check``)."""
    rng = np.random.default_rng(12)
    ids1, patches, grid = _prefix_request(tiny.cfg, rng, [20, 21, 22, 23, 24])
    ids2 = _prefix_request(tiny.cfg, rng, [30, 31, 32, 33, 34, 35, 36, 37])[0]
    with jax.set_mesh(tiny.mesh):
        want = _reuse_run(jax_tp_engine(tiny, tiny.jq, PREFIX_RT), ids1, ids2, patches, grid)[0]
    one, prefix1 = _reuse_run(port_engine(tiny, tiny.pq, PREFIX_RT), ids1, ids2, patches, grid)
    for o, w in zip(one, want):
        np.testing.assert_array_equal(o, w)

    def rank(tp):
        toks, prefix = _reuse_run(port_engine(tiny, tiny.pq, PREFIX_RT, tp), ids1, ids2,
                                  patches, grid)
        heads = kv_slice(tiny.pcfg.num_key_value_heads, tp)
        np.testing.assert_array_equal(npy(prefix.cache.k_scale),
                                      npy(prefix1.cache.k_scale)[:, heads])
        return toks, prefix.cache.k.shape[1], prefix.final_len

    for toks, kv_heads, final_len in run_ranks(rank):
        for g, w in zip(toks, want):
            np.testing.assert_array_equal(g, w)
        assert kv_heads == 1 and final_len == prefix1.final_len


def test_server_tp_prefix_and_vision_caches(tiny):
    """``ContinuousServer.run`` at tp = 2 with the prefix and vision-feature
    caches: two keyed questions (one capture, then hits; a pixel-less one
    too), the tokens and cache stats of the port's tp = 1 server."""
    rng = np.random.default_rng(13)
    ids1, patches, grid = _prefix_request(tiny.cfg, rng, [20, 21, 22, 23, 24])
    ids2 = _prefix_request(tiny.cfg, rng, [30, 31, 32, 33, 34, 35, 36, 37])[0]
    reqs = [_req(ids1, patches, grid, video_key="vidA"),
            _req(ids2, patches, grid, video_key="vidA"), dict(input_ids=ids2, video_key="vidA")]
    keys = ("prefix_cache_hits", "prefix_cache_misses", "vision_cache_hits")

    def serve(tp=None):
        server = ContinuousServer(port_engine(tiny, tiny.pq, PREFIX_RT, tp), **PREFIX_SERVE_KW)
        res = server.run([dict(r) for r in reqs])
        return [np.asarray(r.tokens) for r in res], [server.stats[k] for k in keys]

    want, want_stats = serve()
    assert want_stats[:2] == [2, 1]
    for toks, stats in run_ranks(serve):
        for g, w in zip(toks, want):
            np.testing.assert_array_equal(g, w)
        assert stats == want_stats


def test_llava_tp_engine_matches_jax(tiny_llava):
    """LLaVA at tp = 2 (frame-sharded SigLIP, DPSelect, PivotKV with 1-D
    reforge): the JAX tp = 2 engine's tokens and the port's tp = 1 tokens,
    for ``generate`` and ``generate_batch``."""
    t = tiny_llava
    cfg = t.cfg
    rng = np.random.default_rng(11)
    reqs = []
    for frames in (8, 4):
        n_tok = frames * cfg.tokens_per_frame + 1
        ids = np.array(rng.integers(10, 500, size=4).tolist() + [cfg.video_token_id] * n_tok
                       + rng.integers(10, 500, size=6).tolist(), dtype=np.int64)
        reqs.append(dict(input_ids=ids, pixel_values_videos=rng.integers(
            0, 255, size=(frames, 16, 16, 3), dtype=np.uint8)))
    rt_j = JaxRetakeConfig.from_dict(LLAVA_RT)
    with jax.set_mesh(t.mesh):
        jeng = JaxLlavaEngine(cfg, jmesh.shard_params(t.jp, t.mesh), rt_j,
                              cache_sharding=jmesh.cache_shardings(t.mesh))
        want = jeng.generate(**reqs[0], max_new_tokens=6)
    rt = RetakeConfig.from_dict(LLAVA_RT)
    one = LlavaOnevisionEngine(t.pcfg, t.pp, rt, device="cpu")
    want1 = one.generate(**reqs[0], max_new_tokens=6)
    batch1 = one.generate_batch([dict(r) for r in reqs], max_new_tokens=5)
    np.testing.assert_array_equal(want1.tokens, want.tokens)

    def rank(tp):
        eng = LlavaOnevisionEngine(t.pcfg, shard_params(t.pp, tp), rt, device="cpu", tp=tp)
        return (eng.generate(**reqs[0], max_new_tokens=6),
                eng.generate_batch([dict(r) for r in reqs], max_new_tokens=5))

    for got, batch in run_ranks(rank):
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert got.cache_len == want.cache_len
        for g, o in zip(batch, batch1):
            np.testing.assert_array_equal(g.tokens, o.tokens)


def test_dp2_tp2_four_ranks(tiny):
    """dp = 2 x tp = 2 on four threads: replica d (ranks 2d, 2d + 1, one TP
    group each) runs request d; both chunks keep s / 2 entries and each
    replica's hidden is the unsharded port's for its request (the JAX
    test_dp_batched_requests' check)."""
    pcfg = tiny.pcfg
    rng = np.random.default_rng(7)
    inputs = [_chunk_inputs(tiny.cfg, rng, s=8) for _ in range(2)]
    model1 = Qwen2VLModel(pcfg, tiny.pp)
    refs = [npy(_port_chunk(model1, pcfg, e, p, "xla")[0]) for e, p in inputs]
    groups = [thread_groups(2, f"tp{d}") for d in range(2)]
    out = run_ranks(lambda tp: _replica(tp, pcfg, tiny.pp, inputs),
                    layout=[(_tagged(groups[d], d), r) for d in range(2) for r in range(2)])
    assert sorted(d for d, _, _ in out) == [0, 0, 1, 1]
    for d, hidden, length in out:
        assert length == 4
        np.testing.assert_allclose(hidden, refs[d], atol=1e-4)


def _tagged(make, replica):
    """A group factory whose groups remember their replica index."""
    def build(rank):
        pg = make(rank)
        _REPLICA[id(pg)] = replica
        return pg
    return build


_REPLICA = {}


def _replica(tp, pcfg, tree, inputs):
    d = _REPLICA[id(tp.group)]
    model = Qwen2VLModel(pcfg, shard_params(tree, tp), tp)
    hidden, kv = _port_chunk(model, pcfg, *inputs[d], "xla")
    return d, npy(hidden), int(kv.length)


# ---------------------------------------------------------------- guards


def test_tp_guards(tiny):
    """What TP refuses: KV heads that do not split over tp (a model built
    on tp = 4 with 2 KV heads), an unsharded tree under a handle, an engine
    whose tp is not its model's, a backend other than gloo / nccl, and an
    NCCL group bound to the CPU."""
    def rank(tp):
        with pytest.raises(ValueError, match="columns"):
            Qwen2VLModel(tiny.pcfg, tiny.pp, tp)
        model = Qwen2VLModel(tiny.pcfg, shard_params(tiny.pp, tp), tp)
        with pytest.raises(ValueError, match="not the model"):
            Qwen2VLEngine(tiny.pcfg, model, RetakeConfig.from_dict({}), device="cpu")
        Qwen2VLEngine(tiny.pcfg, model, RetakeConfig.from_dict({}), device="cpu", tp=tp)
        with pytest.raises(ValueError, match="NCCL group cannot carry"):
            TensorParallel(tp.group, backend="nccl").bind("cpu")
        with pytest.raises(ValueError, match="supports"):
            TensorParallel(tp.group, backend="mpi")
        return True

    assert all(run_ranks(rank))

    def rank4(tp):
        with pytest.raises(ValueError, match="do not split"):
            Qwen2VLModel(tiny.pcfg, tiny.pp, tp)
        return True

    assert all(run_ranks(rank4, size=4))


def test_replica_check_raises_on_divergence():
    """``assert_replicated`` raises when the ranks' values differ, and
    passes (starting a new digest) when they agree."""
    from retake_tpu_torch.parallel import ReplicaDivergence

    def rank(tp):
        tp.assert_replicated("same", np.arange(4), torch.ones(3))
        with pytest.raises(ReplicaDivergence, match="differ"):
            tp.assert_replicated("rank", np.full(2, tp.rank))
        return True

    assert all(run_ranks(rank))


# ---------------------------------------------------------------- two processes

_RANK_SCRIPT = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from retake_tpu_torch.models.qwen2_vl import params as params_lib
from retake_tpu_torch.models.qwen2_vl.config import Qwen2VisionConfig, Qwen2VLConfig
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.parallel import make_mesh, shard_params
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.utils.config import RetakeConfig

rank, port, dp, tp, cfg, reqs = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                 int(sys.argv[4]), json.loads(sys.argv[5]), json.loads(sys.argv[6]))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=dp * tp,
                        rank=rank)
mesh = make_mesh(dp=dp, tp=tp, backend="gloo")
mesh.tp.check = True
members = mesh.tp.all_gather(torch.tensor([rank])).tolist()  # the global ranks of my tp group
cfg["vision"] = Qwen2VisionConfig(**cfg["vision"])
cfg["mrope_section"] = tuple(cfg["mrope_section"])
cfg = Qwen2VLConfig(**cfg)
params = params_lib.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
model = Qwen2VLModel(cfg, shard_params(params, mesh.tp), mesh.tp)
req = reqs[mesh.dp_rank]
eng = Qwen2VLEngine(cfg, model, RetakeConfig.from_dict(req["rd"]), device="cpu", tp=mesh.tp)
with torch.no_grad():
    res = eng.generate(np.asarray(req["ids"]), np.asarray(req["patches"], np.float32),
                       np.asarray(req["grid"]), max_new_tokens=6)
dist.destroy_process_group()
print(json.dumps({"rank": rank, "dp_rank": mesh.dp_rank, "members": members,
                  "tokens": res.tokens.tolist(), "calls": mesh.tp.calls}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_processes_through_make_mesh(tiny, dp, tp):
    """``dp * tp`` OS processes join a gloo group and ``make_mesh(dp, tp)``:
    each rank's tp group is the consecutive ranks of its replica (``rank //
    tp``), checked by an all-gather of the global ranks over it. Every rank
    builds the sharded tiny model from the same seed and runs its replica's
    request: equal tokens within a replica (digests checked), equal to the
    port's tp = 1 engine on the same weights."""
    from retake_tpu_torch.models.qwen2_vl import params as tparams

    rd = RETAKE
    rng = np.random.default_rng(8)
    requests = [video_request(tiny.cfg, rng, grid_t=4, prompt_len=4 + d) for d in range(dp)]
    params = tparams.init_params(tiny.pcfg, seed=0, dtype=torch.float32, device="cpu")
    eng = Qwen2VLEngine(tiny.pcfg, Qwen2VLModel(tiny.pcfg, params), RetakeConfig.from_dict(rd),
                        device="cpu")
    want = [eng.generate(*r, max_new_tokens=6).tokens.tolist() for r in requests]
    cfg = dataclasses.asdict(tiny.pcfg)
    reqs = [{"rd": rd, "ids": i.tolist(), "patches": p.tolist(), "grid": g.tolist()}
            for i, p, g in requests]
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, str(r), str(port), str(dp),
                               str(tp), json.dumps(cfg), json.dumps(reqs)], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(dp * tp)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=JOIN_S)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, o in enumerate(outs):
        d = r // tp
        assert o["rank"] == r and o["dp_rank"] == d
        assert o["members"] == list(range(d * tp, (d + 1) * tp))
        assert o["tokens"] == want[d] and o["calls"] > 0
