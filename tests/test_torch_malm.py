"""MA-LLM / MA-LLM-hard visual compression of the port against the JAX
package on the CPU, fp32: ``ops/dpselect.malm_compress`` for (sync, hard)
in {F, T}^2 (tests/test_dpselect.py::test_malm_sync_matches_torch's shape
and more; 1e-6), and ``generate`` under MA-LLM and MA-LLM-hard (the JAX
engine's tokens and cache plan, exactly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu.ops import dpselect as jdp
from retake_tpu.runtime.engine import Qwen2VLEngine as JaxEngine
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.ops import dpselect as tdp
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import port_cfg, port_params, tiny_cfg, video_request


@pytest.mark.parametrize("sync,hard", [(False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("t,n,c,tgt", [(9, 3, 5, 5), (16, 4, 8, 3), (6, 1, 4, 6), (5, 7, 3, 1)])
def test_malm_compress_matches_jax(rng, sync, hard, t, n, c, tgt):
    bank = rng.normal(size=(t, n, c)).astype(np.float32)
    want = np.asarray(jdp.malm_compress(jnp.asarray(bank), tgt, sync=sync, hard=hard))
    got = tdp.malm_compress(torch.from_numpy(bank), tgt, sync=sync, hard=hard)
    assert got.shape == (tgt, n, c)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_malm_hard_keeps_bank_rows(rng):
    """MA-LLM-hard only overwrites: every output row is an input row of its
    patch column."""
    bank = rng.normal(size=(10, 3, 4)).astype(np.float32)
    out = tdp.malm_compress(torch.from_numpy(bank), 4, hard=True).numpy()
    for col in range(3):
        for row in out[:, col]:
            assert any(np.array_equal(row, b) for b in bank[:, col])


@pytest.mark.parametrize("sync", [False, True])
def test_malm_hard_compress_matches_jax(rng, sync):
    """``malm_hard_compress`` (the MA-LLM-hard entry point) against the JAX
    function on the same bank, 1e-6."""
    bank = rng.normal(size=(12, 3, 5)).astype(np.float32)
    want = np.asarray(jdp.malm_hard_compress(jnp.asarray(bank), 4, sync=sync))
    got = tdp.malm_hard_compress(torch.from_numpy(bank), 4, sync=sync)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_merge_once_matches_jax(rng):
    """One merge step from a bank with dead frames: bank and sizes."""
    bank = rng.normal(size=(7, 2, 3)).astype(np.float32)
    sizes = np.ones((7, 2), np.float32)
    sizes[[1, 4]] = 0.0
    sizes[2] = 3.0
    for sync in (False, True):
        for hard in (False, True):
            jb, js = jdp._merge_once(jnp.asarray(bank), jnp.asarray(sizes), sync, hard)
            tb, ts = tdp._merge_once(torch.from_numpy(bank), torch.from_numpy(sizes), sync, hard)
            np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6)
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg()
    jp = jparams.init_params(cfg, seed=0, dtype=jnp.float32)
    return cfg, jp, Qwen2VLModel(port_cfg(cfg), port_params(jp))


@pytest.mark.parametrize("sync", [False, True])
@pytest.mark.parametrize("method", ["MA-LLM", "MA-LLM-hard"])
def test_generate_malm_matches_jax_engine(tiny, method, sync):
    """A request whose 8 frames (4 after the temporal patch) merge to 2, then
    chunked prefill with PivotKV: the JAX engine's tokens and cache plan;
    the features have tgt * hw rows and no keypatch."""
    cfg, jp, model = tiny
    rd = {"longvideo_kwargs": {
        "chunked_prefill_frames": 2, "frame_chunk_size": 2,
        "visual_compression": True,
        "visual_compression_kwargs": {"compression_ratio": 0.5, "compression_method": method,
                                      "patch_sync": sync},
        "kvcache_compression": True,
        "kvcache_compression_kwargs": {"compression_ratio": 0.6, "pos_embed_reforge": True},
    }}
    ids, patches, grid = video_request(cfg, np.random.default_rng(8), grid_t=4, prompt_len=6)
    want = JaxEngine(cfg, jp, JaxRetakeConfig.from_dict(rd)).generate(ids, patches, grid,
                                                                     max_new_tokens=8)
    eng = Qwen2VLEngine(port_cfg(cfg), model, RetakeConfig.from_dict(rd), device="cpu")
    got = eng.generate(ids, patches, grid, max_new_tokens=8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.cache_len == want.cache_len == got.cache_fill
    assert got.input_len == want.input_len < len(ids)  # ids reforged to the merged frames
    feats = eng.encode_video(patches, grid)
    assert (feats.t, feats.tgt) == (4, 2) and feats.embeds.shape[0] == 2 * feats.hw
    assert not feats.keymask.any()
