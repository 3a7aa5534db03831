"""The port's LLaVA-OneVision / LLaVA-Video path against the JAX package on
the CPU in fp32: the engine's tokens on the tiny configs of
tests/test_llava.py (unchunked, chunked, the ReTaKe path, anyres images,
image + video, ``video_features=`` and ``prefix=`` reuse, the server's
prefix cache), and elementwise: SigLIP, anyres packing, pooling, the
projector, ``quantize_siglip_int8`` (bit for bit, op by op), both HF naming
eras, the processor, the config copy.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from retake_tpu.data import processor as jproc
from retake_tpu.models.llava_onevision import anyres as janyres
from retake_tpu.models.llava_onevision import params as jparams
from retake_tpu.models.llava_onevision import siglip as jsiglip
from retake_tpu.models.llava_onevision.config import LlavaOnevisionConfig, SiglipVisionConfig
from retake_tpu.models.qwen2_vl.config import Qwen2VLConfig
from retake_tpu.ops import quantization as jq8
from retake_tpu.runtime.llava_engine import LlavaOnevisionEngine as JaxEngine
from retake_tpu.runtime.serve import ContinuousServer as JaxServer
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.data import processor as tproc
from retake_tpu_torch.models.llava_onevision import anyres as tanyres
from retake_tpu_torch.models.llava_onevision import config as tconfig
from retake_tpu_torch.models.llava_onevision import params as tparams
from retake_tpu_torch.models.llava_onevision import siglip as tsiglip
from retake_tpu_torch.models.llava_onevision.model import LlavaOnevisionModel
from retake_tpu_torch.ops import quantization as tq8
from retake_tpu_torch.runtime.llava_engine import LlavaOnevisionEngine
from retake_tpu_torch.runtime.serve import ContinuousServer
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import npy, port_cfg, tt

CHUNKED = {"longvideo_kwargs": {"chunked_prefill_frames": 2, "frame_chunk_size": 4}}
RETAKE = {"longvideo_kwargs": {
    "chunked_prefill_frames": 2, "frame_chunk_size": 4,
    "visual_compression": True,
    "visual_compression_kwargs": {"compression_ratio": 0.5, "compression_method": "Keyframe",
                                  "patch_sync": False, "return_keyframe_mask": True},
    "kvcache_compression": True,
    "kvcache_compression_kwargs": {"dynamic_compression_ratio": True,
                                   "compression_method": "pivotkv", "pos_embed_reforge": True,
                                   "max_input_length": 16},
}}
PINS = ((16, 16), (16, 32), (32, 16), (32, 32))


def port_llava_cfg(cfg: LlavaOnevisionConfig) -> tconfig.LlavaOnevisionConfig:
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["text"] = port_cfg(cfg.text)
    d["vision"] = tconfig.SiglipVisionConfig(**dataclasses.asdict(cfg.vision))
    return tconfig.LlavaOnevisionConfig(**d)


@pytest.fixture(scope="module")
def tiny():
    """The tiny HF LlavaOnevision model of tests/test_llava.py and its
    weights in both packages (anyres pinpoints of the tiny tiles)."""
    text_cfg = dict(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=4096,
        rope_theta=10000.0, tie_word_embeddings=False, bos_token_id=0, eos_token_id=1,
        model_type="qwen2",
    )
    vision_cfg = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=2, image_size=16, patch_size=4,
                      model_type="siglip_vision_model", vision_use_head=False)
    hf_cfg = transformers.LlavaOnevisionConfig(
        text_config=text_cfg, vision_config=vision_cfg, image_token_index=5,
        video_token_index=6, vision_feature_select_strategy="full", vision_feature_layer=-1,
    )
    torch.manual_seed(3)
    hf_model = transformers.LlavaOnevisionForConditionalGeneration(hf_cfg).eval().float()
    cfg = LlavaOnevisionConfig(
        text=Qwen2VLConfig(
            vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=4096,
            rope_theta=10000.0, tie_word_embeddings=False, bos_token_id=0, eos_token_id=1,
            mrope_section=None,
        ),
        vision=SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                  num_attention_heads=2, image_size=16, patch_size=4),
        image_token_id=5, video_token_id=6, image_grid_pinpoints=PINS,
    )
    jp = jparams.from_torch_model(cfg, hf_model, dtype=jnp.float32)
    pcfg = port_llava_cfg(cfg)
    tp = tparams.from_torch_model(pcfg, hf_model, dtype=torch.float32, device="cpu")
    return hf_model, cfg, jp, pcfg, LlavaOnevisionModel(pcfg, tp)


def make_request(cfg, rng, frames=3, post=6):
    n_tok = frames * cfg.tokens_per_frame + 1  # +1 image_newline
    ids = np.array(rng.integers(10, 500, size=4).tolist() + [cfg.video_token_id] * n_tok
                   + rng.integers(10, 500, size=post).tolist(), dtype=np.int64)
    vid = rng.integers(0, 255, size=(frames, cfg.vision.image_size, cfg.vision.image_size, 3),
                       dtype=np.uint8)
    return ids, vid


def engines(tiny, rd):
    _, cfg, jp, pcfg, model = tiny
    return (JaxEngine(cfg, jp, JaxRetakeConfig.from_dict(rd)),
            LlavaOnevisionEngine(pcfg, model, RetakeConfig.from_dict(rd), device="cpu"))


def _anyres_image(cfg, rng, oh, ow):
    n_patch = janyres.image_size_to_num_patches((oh, ow), cfg.image_grid_pinpoints,
                                                cfg.vision.image_size)
    s = cfg.vision.image_size
    tiles = rng.integers(0, 255, size=(1, n_patch, s, s, 3), dtype=np.uint8)
    n_tok = janyres.packed_token_count((oh, ow), grid_side=cfg.grid_side,
                                       pinpoints=cfg.image_grid_pinpoints, tile_size=s)
    return tiles, np.array([[oh, ow]]), n_tok


# ---------------------------------------------------------------- requests


@pytest.mark.parametrize("case", ["unchunked", "chunked", "retake", "retake-flash"])
def test_llava_generate_matches_jax(tiny, case):
    """Tokens and first logits of the JAX engine: the whole prompt in one
    step, chunked prefill (2 frames a chunk, SigLIP in chunks of 4), and
    the ReTaKe path (DPSelect at ratio 0.5 on the pre-projector features,
    the keypatch truncation, PivotKV with 1-D reforge), also under "flash"."""
    rd, frames = {"unchunked": ({}, 3), "chunked": (CHUNKED, 6), "retake": (RETAKE, 8),
                  "retake-flash": (dict(RETAKE, attn_implementation="flash"), 8)}[case]
    jeng, teng = engines(tiny, rd)
    ids, vid = make_request(tiny[1], np.random.default_rng(11), frames=frames)
    want = jeng.generate(ids, vid, max_new_tokens=6)
    got = teng.generate(ids, vid, max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.cache_len == want.cache_len and got.input_len == want.input_len
    if case.startswith("retake"):
        assert got.input_len < len(ids) and got.cache_len < got.input_len


def test_llava_matches_hf(tiny):
    """The port against HF transformers itself, chunked (tests/test_llava.py)."""
    hf_model, cfg, _, _, _ = tiny
    ids, vid = make_request(cfg, np.random.default_rng(12), frames=6)
    px = torch.from_numpy((vid.astype(np.float32) / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2)[None]
    with torch.no_grad():
        want = hf_model.generate(input_ids=torch.from_numpy(ids)[None], pixel_values_videos=px,
                                 do_sample=False, max_new_tokens=6)[0, len(ids):].numpy()
    got = engines(tiny, CHUNKED)[1].generate(ids, vid, max_new_tokens=6)
    np.testing.assert_array_equal(got.tokens, want)


@pytest.mark.parametrize("mixed", [False, True])
def test_llava_images_match_jax(tiny, mixed):
    """An anyres image alone (20x35: four grid tiles, unpadded), and a
    one-tile image before a 4-frame video, chunked."""
    cfg = tiny[1]
    rng = np.random.default_rng(13)
    if mixed:
        tiles, sizes, n_tok = _anyres_image(cfg, rng, 16, 16)
        _, vid = make_request(cfg, rng, frames=4)
        ids = np.array([10] + [cfg.image_token_id] * n_tok + [12]
                       + [cfg.video_token_id] * (4 * cfg.tokens_per_frame + 1) + [30, 31])
    else:
        tiles, sizes, n_tok = _anyres_image(cfg, rng, 20, 35)
        vid = None
        ids = np.array([10, 11] + [cfg.image_token_id] * n_tok + [30, 31])
    jeng, teng = engines(tiny, CHUNKED if mixed else {})
    want = jeng.generate(ids, vid, max_new_tokens=6, pixel_values=tiles, image_sizes=sizes)
    got = teng.generate(ids, vid, max_new_tokens=6, pixel_values=tiles, image_sizes=sizes)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_llava_video_features_and_prefix_reuse(tiny):
    """``encode_video`` then ``generate(video_features=)``, and
    ``encode_prefix`` then ``generate(prefix=)``, for two questions on one
    video under the ReTaKe config (tgt != t truncation): equal to the
    port's inline tokens and to the JAX engine's."""
    cfg = tiny[1]
    rng = np.random.default_rng(14)
    ids1, vid = make_request(cfg, rng, frames=8)
    ids2 = np.concatenate([ids1[:-6], rng.integers(10, 500, size=9)])
    jeng, teng = engines(tiny, RETAKE)
    rd = copy.deepcopy(RETAKE)
    rd["longvideo_kwargs"]["kvcache_compression_kwargs"] = {
        "compression_ratio": 0.5, "compression_method": "pivotkv", "pos_embed_reforge": True}
    _, peng = engines(tiny, rd)  # a fixed ratio: the plan is question-independent
    feats = teng.encode_video(vid)
    prefix = peng.encode_prefix(ids1, vid, max_new_tokens=5)
    for ids in (ids1, ids2):
        want = jeng.generate(ids, vid, max_new_tokens=4)
        inline = teng.generate(ids, vid, max_new_tokens=4)
        reused = teng.generate(ids, video_features=feats, max_new_tokens=4)
        np.testing.assert_array_equal(inline.tokens, want.tokens)
        np.testing.assert_array_equal(reused.tokens, inline.tokens)
        p_inline = peng.generate(ids, vid, max_new_tokens=5)
        p_reused = peng.generate(ids, prefix=prefix, max_new_tokens=5)
        np.testing.assert_array_equal(p_reused.tokens, p_inline.tokens)
        assert p_reused.cache_len == p_inline.cache_len


def test_llava_server_prefix_cache_matches_jax(tiny):
    """``ContinuousServer`` over the LLaVA engine with the prefix cache
    (tests/test_serve.py::test_serve_prefix_cache_llava): two questions on
    one keyed video and a pixel-less re-ask; tokens equal to the JAX
    server's and to sequential ``generate``; SigLIP runs once."""
    _, cfg, _, _, _ = tiny
    rd = {"longvideo_kwargs": {"chunked_prefill_frames": 2, "frame_chunk_size": 2}}
    jeng, teng = engines(tiny, rd)
    rng = np.random.default_rng(15)
    frames = 2
    n_tok = frames * cfg.tokens_per_frame + 1
    pre = rng.integers(10, 500, size=4).tolist()
    vid = rng.integers(0, 255, size=(frames, cfg.vision.image_size, cfg.vision.image_size, 3),
                       dtype=np.uint8)
    ids1 = np.array(pre + [6] * n_tok + rng.integers(10, 500, size=6).tolist(), dtype=np.int64)
    ids2 = np.array(pre + [6] * n_tok + rng.integers(10, 500, size=4).tolist(), dtype=np.int64)
    reqs = [dict(input_ids=ids1, pixel_values_videos=vid, video_key="v"),
            dict(input_ids=ids2, pixel_values_videos=vid, video_key="v"),
            dict(input_ids=ids2, video_key="v")]
    kw = dict(batch_slots=2, segment_steps=2, max_new_tokens=6, gap_capacity=4,
              prefix_cache_slots=1)
    want = JaxServer(jeng, **kw).run([dict(r) for r in reqs])
    n_enc = 0
    real = teng.encode_video

    def counting(*a, **k):
        nonlocal n_enc
        n_enc += 1
        return real(*a, **k)

    teng.encode_video = counting
    server = ContinuousServer(teng, **kw)
    got = server.run([dict(r) for r in reqs])
    seq = [teng.generate(i, vid, max_new_tokens=6).tokens for i in (ids1, ids2, ids2)]
    for g, w, s in zip(got, want, seq):
        np.testing.assert_array_equal(g.tokens, w.tokens)
        np.testing.assert_array_equal(g.tokens, s)
    assert server.stats["prefix_cache_hits"] == 2 and server.stats["prefix_cache_misses"] == 1
    assert n_enc == 4  # the capture's SigLIP pass; the other three are the sequential runs


def test_llava_generate_batch_matches_sequential(tiny):
    """Sequential prefill and one batched decode (``decode_batch``) give
    each request's sequential tokens."""
    _, teng = engines(tiny, CHUNKED)
    rng = np.random.default_rng(16)
    reqs = [dict(zip(("input_ids", "pixel_values_videos"), make_request(tiny[1], rng, frames=f)))
            for f in (4, 6)]
    seq = [teng.generate(**r, max_new_tokens=5).tokens for r in reqs]
    for b, s in zip(teng.generate_batch(reqs, max_new_tokens=5), seq):
        np.testing.assert_array_equal(b.tokens, s)


# ---------------------------------------------------------------- modules


def test_siglip_tower_projector_and_pooling_match_jax(tiny):
    """Patchify (with the valid-conv crop), the tower, the projector and
    the 2x2 bilinear pooling, elementwise (fp32, atol 1e-5)."""
    _, cfg, jp, pcfg, model = tiny
    frames = np.random.default_rng(17).integers(0, 255, (3, 16, 16, 3), dtype=np.uint8)
    jpatch = jsiglip.patchify_frames(jnp.asarray(frames), cfg.vision, jnp.float32)
    tpatch = tsiglip.patchify_frames(tt(frames), pcfg.vision, torch.float32)
    np.testing.assert_array_equal(npy(tpatch), np.asarray(jpatch))
    jf = jsiglip.siglip_tower(jp["vision_tower"], cfg.vision, jpatch)
    tf = tsiglip.siglip_tower(model.vision_tower, pcfg.vision, tpatch)
    np.testing.assert_allclose(npy(tf), np.asarray(jf), atol=1e-5)
    jproj = jsiglip.multi_modal_projector(jp["projector"], jf)
    tproj = tsiglip.multi_modal_projector(model.projector.as_dict(), tf)
    np.testing.assert_allclose(npy(tproj), np.asarray(jproj), atol=1e-5)
    for grid, pooled in ((cfg.grid_side, cfg.pooled_grid), (27, 14)):
        x = np.random.default_rng(grid).normal(size=(2, grid * grid, 8)).astype(np.float32)
        np.testing.assert_allclose(npy(tsiglip.apply_pooling(tt(x), grid, pooled)),
                                   np.asarray(jsiglip.apply_pooling(jnp.asarray(x), grid, pooled)),
                                   atol=1e-5)


def test_patchify_crops_like_the_valid_conv():
    """384 px / patch 14 leaves 6 trailing pixels the conv drops (the
    so400m geometry); a 20 px / patch 6 frame the same way."""
    vcfg = tconfig.SiglipVisionConfig(hidden_size=8, intermediate_size=16, num_hidden_layers=1,
                                      num_attention_heads=2, image_size=20, patch_size=6)
    frames = np.random.default_rng(18).integers(0, 255, (2, 20, 20, 3), dtype=np.uint8)
    patches = tsiglip.patchify_frames(tt(frames), vcfg, torch.float32)
    w = torch.from_numpy(np.random.default_rng(19).normal(size=(8, 3, 6, 6)).astype(np.float32))
    px = torch.from_numpy((frames.astype(np.float32) / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2)
    want = torch.nn.functional.conv2d(px, w, stride=6).flatten(2).transpose(1, 2)
    torch.testing.assert_close(patches @ w.reshape(8, -1).T, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hw", [(16, 16), (20, 35), (40, 17), (31, 31)])
def test_anyres_packing_matches_jax(tiny, hw):
    """Geometry and ``pack_image_feature`` (unpad, the anyres_max
    downscale, a newline per row) against the JAX module; anyres_max_1
    forces the bilinear downscale."""
    cfg = tiny[1]
    g, s = cfg.grid_side, cfg.vision.image_size
    assert tanyres.select_best_resolution(hw, PINS) == janyres.select_best_resolution(hw, PINS)
    n = janyres.image_size_to_num_patches(hw, PINS, s)
    assert tanyres.image_size_to_num_patches(hw, PINS, s) == n
    rng = np.random.default_rng(20)
    feat = rng.normal(size=(n, g * g, 8)).astype(np.float32)
    newline = rng.normal(size=(8,)).astype(np.float32)
    for ratio in ("anyres_max_9", "anyres_max_1"):
        kw = dict(grid_side=g, pinpoints=PINS, tile_size=s, vision_aspect_ratio=ratio)
        want = janyres.pack_image_feature(jnp.asarray(feat), hw, image_newline=jnp.asarray(newline),
                                          **kw)
        got = tanyres.pack_image_feature(tt(feat), hw, image_newline=tt(newline), **kw)
        np.testing.assert_allclose(npy(got), np.asarray(want), atol=1e-5)
        assert got.shape[0] == tanyres.packed_token_count(hw, **kw)
    img = rng.integers(0, 255, (hw[0] * 3, hw[1] * 3, 3), dtype=np.uint8)
    jt, jhw = janyres.image_to_anyres_tiles(img, tile_size=s, pinpoints=PINS)
    ttl, thw = tanyres.image_to_anyres_tiles(img, tile_size=s, pinpoints=PINS)
    np.testing.assert_array_equal(ttl, jt)
    assert thw == jhw


def test_quantize_siglip_int8_is_bit_exact(tiny):
    """The port's quantizer of the bridged tree == the JAX one run op by op
    (the jitted JAX quantizer multiplies by 1/127, which can move a scale
    by one ulp), leaf for leaf."""
    _, _, jp, _, _ = tiny
    with jax.disable_jit():
        want = jq8.quantize_siglip_int8(jp)
    got = tq8.quantize_siglip_int8(tparams.from_jax_params(jax.tree.map(np.asarray, jp)))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, leaf in flat_w:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(npy(node), np.asarray(leaf), err_msg=str(path))
    assert got["vision_tower"]["blocks"]["q"]["w"].dtype == torch.int8
    assert got["projector"]["linear_2"]["w"].dtype == torch.int8


def test_w8a8_llava_runs_and_repeats(tiny):
    """W8A8 (int8 text, SigLIP and projector): the SigLIP linears run
    W8A8, the request repeats bit-exactly."""
    _, _, _, pcfg, model = tiny
    params = tq8.quantize_siglip_int8(tq8.quantize_llm_int8(
        {k: v for k, v in _tree(model).items()}))
    rd = dict(CHUNKED, quantization="w8a8")
    eng = LlavaOnevisionEngine(pcfg, params, RetakeConfig.from_dict(rd), device="cpu")
    assert eng.act_quant and eng._vision_aq()
    ids, vid = make_request(tiny[1], np.random.default_rng(21), frames=4)
    a, b = (eng.generate(ids, vid, max_new_tokens=4) for _ in range(2))
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.first_logits, b.first_logits)


def _tree(model) -> dict:
    """A model's parameters as the nested tree it was built from."""
    tree = {}
    for name, p in model.state_dict().items():
        node = tree
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = p
    return tree


@pytest.mark.parametrize("era", ["old", "new", "lmms"])
def test_hf_naming_eras_load_to_the_jax_tree(tiny, era):
    """The HF state dict under the pre-4.52 names, the current names, and
    the lmms-lab LLaVA-Video names through ``convert_llava_video_weights``:
    every leaf equal to the JAX ``from_hf_tensors`` of the current names."""
    hf_model, cfg, jp, pcfg, _ = tiny
    sd = {k: v.detach() for k, v in hf_model.state_dict().items()}
    if era == "old":
        sd = {k.replace("model.language_model.", "language_model.model.")
              .replace("model.vision_tower.", "vision_tower.")
              .replace("model.multi_modal_projector.", "multi_modal_projector.")
              .replace("model.image_newline", "image_newline")
              .replace("lm_head.", "language_model.lm_head."): v for k, v in sd.items()}
    elif era == "lmms":
        lmms = {}
        for k, v in sd.items():
            k = k.replace("model.language_model.", "model.").replace(
                "model.vision_tower.vision_model.", "model.vision_tower.vision_tower.vision_model.")
            k = k.replace("model.multi_modal_projector.linear_1.", "model.mm_projector.0.").replace(
                "model.multi_modal_projector.linear_2.", "model.mm_projector.2.")
            lmms[k] = v
        sd = tparams.convert_llava_video_weights(lmms)
    got = tparams.from_hf_tensors(pcfg, sd, torch.float32, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(npy(node), np.asarray(leaf), err_msg=str(path))


def test_video_processor_matches_jax():
    """Square frames, anyres tiles, the placeholder span, ``num_frames``."""
    class Tok:
        def encode(self, s):
            return [7 + b % 100 for b in s.encode()]

        def decode(self, ids, **kw):
            return " ".join(map(str, ids))

    kw = dict(video_token_id=6, image_token_id=5, image_size=16, patch_size=4,
              tokens_per_frame=4, image_grid_pinpoints=PINS)
    rng = np.random.default_rng(22)
    frames = [rng.integers(0, 255, (24, 40, 3), dtype=np.uint8) for _ in range(3)]
    images = [rng.integers(0, 255, (20, 35, 3), dtype=np.uint8)]
    jp_, tp_ = jproc.LlavaOnevisionVideoProcessor(Tok(), **kw), \
        tproc.LlavaOnevisionVideoProcessor(Tok(), **kw)
    for args in (dict(frames=frames, images=images), dict(num_frames=5)):
        want, got = jp_("why?", **args), tp_("why?", **args)
        for key in want:
            if want[key] is None:
                assert got[key] is None, key
            else:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_llava_config_copy_matches_the_original(tiny):
    """Field for field, defaults and ``from_hf_dict`` of the tiny model's
    HF config; the 7B defaults are LLaVA-Video-7B's (28 layers, hidden
    3584, 28/4 heads, SigLIP 26 x 1152, 196 tokens a frame)."""
    from retake_tpu.models.llava_onevision import config as jconfig

    hf_model = tiny[0]
    for a, b in ((jconfig.LlavaOnevisionConfig, tconfig.LlavaOnevisionConfig),
                 (jconfig.SiglipVisionConfig, tconfig.SiglipVisionConfig)):
        assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    d = hf_model.config.to_dict()
    assert dataclasses.asdict(tconfig.LlavaOnevisionConfig.from_hf_dict(d)) == dataclasses.asdict(
        jconfig.LlavaOnevisionConfig.from_hf_dict(d))
    got, want = tconfig.LlavaOnevisionConfig(), jconfig.LlavaOnevisionConfig()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.tokens_per_frame, got.text.num_hidden_layers, got.text.hidden_size) == (196, 28, 3584)
    assert got.text.mrope_section is None and got.vision.num_patches == 729
    assert dataclasses.asdict(got.with_yarn(4)) == dataclasses.asdict(want.with_yarn(4))


def test_llava_init_quantizes_as_it_draws():
    """``init_params(quantize_int8=, quantize_vision_int8=)`` == the
    quantizers applied to the unquantized tree of the same seed."""
    cfg = tconfig.LlavaOnevisionConfig(
        text=port_cfg(Qwen2VLConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                                    num_hidden_layers=2, num_attention_heads=4,
                                    num_key_value_heads=2, mrope_section=None)),
        vision=tconfig.SiglipVisionConfig(hidden_size=16, intermediate_size=32,
                                          num_hidden_layers=2, num_attention_heads=2,
                                          image_size=16, patch_size=4))
    got = tparams.init_params(cfg, seed=5, dtype=torch.float32, device="cpu",
                              quantize_int8=True, quantize_vision_int8=True)
    want = tq8.quantize_siglip_int8(tq8.quantize_llm_int8(
        tparams.init_params(cfg, seed=5, dtype=torch.float32, device="cpu")))
    flat = lambda t: dict(_items(t))  # noqa: E731
    g, w = flat(got), flat(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("quantized", [False, True])
def test_load_llava_engine_from_a_checkpoint_directory(tiny, tmp_path, quantized):
    """``load_llava_engine``: the tiny HF model saved with
    ``save_pretrained`` (HF safetensors), or a pre-quantized tree written by
    ``save_params`` beside its config.json; tokens equal to an engine over
    the same weights built in memory."""
    from retake_tpu_torch.runtime.llava_engine import load_llava_engine
    from retake_tpu_torch.utils import checkpoint

    hf_model, cfg, _, pcfg, model = tiny
    path = str(tmp_path / "llava")
    hf_model.save_pretrained(path)
    rd = dict(CHUNKED, quantization="int8") if quantized else CHUNKED
    rt = RetakeConfig.from_dict(rd)
    # HF safetensors load in bf16 (the loaders' default); the saved tree as it is
    tree = _tree(model) if quantized else tparams.from_torch_model(
        pcfg, hf_model, torch.bfloat16, device="cpu")
    if quantized:
        tree = tq8.quantize_llm_int8(tree)
        for f in os.listdir(path):
            if f.endswith(".safetensors"):
                os.remove(os.path.join(path, f))
        checkpoint.save_params(tree, path, meta={"model_name": "llava_video"})
    eng = load_llava_engine(path, rt, device="cpu")
    ids, vid = make_request(cfg, np.random.default_rng(23), frames=4)
    got = eng.generate(ids, vid, max_new_tokens=5)
    want = LlavaOnevisionEngine(pcfg, tree, rt, device="cpu").generate(ids, vid, max_new_tokens=5)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.first_logits, want.first_logits)


def test_llava_engine_defaults_to_the_card(tiny):
    """No new entry point runs on the CPU unless asked: on a host without
    CUDA the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, _, _, pcfg, model = tiny
    with pytest.raises(RuntimeError, match="cuda"):
        LlavaOnevisionEngine(pcfg, model, RetakeConfig())
