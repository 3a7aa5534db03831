"""The port's jax-free copies (config dataclasses, RetakeConfig, host
positions) against the JAX package's originals, and the port's isolation:
it never imports jax or the JAX package, and its CUDA main path refuses to
run on a host without CUDA.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from retake_tpu.models.qwen2_vl import config as jconfig
from retake_tpu.utils import positions as jpos
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.models.qwen2_vl import config as tconfig
from retake_tpu_torch.utils import positions as tpos
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING else None)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("pair", [
    (jconfig.Qwen2VLConfig, tconfig.Qwen2VLConfig),
    (jconfig.Qwen2VisionConfig, tconfig.Qwen2VisionConfig),
])
def test_model_config_copies_have_the_same_fields(pair):
    j, t = pair
    assert _fields(j) == _fields(t)
    assert dataclasses.asdict(port_cfg(jconfig.TINY_TEST_CONFIG)) == dataclasses.asdict(
        jconfig.TINY_TEST_CONFIG
    )
    assert port_cfg(jconfig.TINY_TEST_CONFIG).head_dim == jconfig.TINY_TEST_CONFIG.head_dim


def test_2b_geometry_matches_bench():
    """qwen2_vl_2b() is the geometry bench.py build_model constructs."""
    want = jconfig.Qwen2VLConfig(
        vocab_size=151936, hidden_size=1536, intermediate_size=8960,
        num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
        tie_word_embeddings=True, vision=jconfig.Qwen2VisionConfig(hidden_size=1536),
    )
    assert dataclasses.asdict(tconfig.qwen2_vl_2b()) == dataclasses.asdict(want)


def test_7b_geometry_matches_the_jax_default():
    """qwen2_vl_7b() is the JAX default Qwen2VLConfig() field by field:
    vocab 152064, hidden 3584, 28 layers, 28 q / 4 kv heads of 128, untied
    LM head, ViT 32 x 1280 projecting to 3584."""
    got, want = tconfig.qwen2_vl_7b(), jconfig.Qwen2VLConfig()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.vocab_size, got.hidden_size, got.intermediate_size) == (152064, 3584, 18944)
    assert (got.num_hidden_layers, got.num_attention_heads, got.num_key_value_heads) == (28, 28, 4)
    assert got.head_dim == want.head_dim == 128 and not got.tie_word_embeddings
    assert (got.vision.depth, got.vision.embed_dim, got.vision.hidden_size) == (32, 1280, 3584)


def _config_dicts():
    out = [{}, {"attn_implementation": "sdpa", "scaling_factor": 4, "unknown_key": 1}]
    for name in ("retake_demo.yaml", "retake_demo_xla.yaml"):
        with open(os.path.join(REPO, "configs", name)) as f:
            out.append(yaml.safe_load(f))
    return out


@pytest.mark.parametrize("i", range(4))
def test_retake_config_copy_parses_like_the_original(i):
    d = _config_dicts()[i]
    assert dataclasses.asdict(RetakeConfig.from_dict(d)) == dataclasses.asdict(
        JaxRetakeConfig.from_dict(d)
    )
    for n in (100, 40000):
        assert RetakeConfig.from_dict(d).compression_ratio_for(n) == JaxRetakeConfig.from_dict(
            d
        ).compression_ratio_for(n)


@pytest.mark.parametrize("bad", [{"quantization": "fp4"}, {"kv_cache_dtype": "fp8"},
                                 {"spec_decode": True, "do_sample": True}])
def test_retake_config_copy_rejects_like_the_original(bad):
    with pytest.raises(ValueError):
        JaxRetakeConfig.from_dict(bad)
    with pytest.raises(ValueError):
        RetakeConfig.from_dict(bad)


@pytest.mark.parametrize("grid_t", [1, 4])
def test_positions_copy_matches_original(rng, grid_t):
    kw = dict(spatial_merge_size=2, image_token_id=5, video_token_id=6, vision_start_token_id=3)
    n = grid_t * 4 * 6 // 4
    ids = np.array([11, 12, 3] + [6] * n + [4, 13, 14, 15], dtype=np.int64)
    grid = np.array([[grid_t, 4, 6]])
    jp, jd = jpos.get_rope_index(ids, video_grid_thw=grid, **kw)
    tp, td = tpos.get_rope_index(ids, video_grid_thw=grid, **kw)
    np.testing.assert_array_equal(tp, jp)
    assert td == jd
    assert tpos.segment_modalities(ids, 6) == jpos.segment_modalities(ids, 6)
    span = (3, 3 + n)
    for a, b in zip(tpos.reforge_after_visual_compression(ids, jp, span, n // 2, 1),
                    jpos.reforge_after_visual_compression(ids, jp, span, n // 2, 1)):
        np.testing.assert_array_equal(a, b)


def test_port_never_imports_jax_or_the_jax_package():
    code = (
        "import sys\n"
        "import retake_tpu_torch\n"
        "import retake_tpu_torch.runtime.engine, retake_tpu_torch.ops.cuda._build\n"
        "import retake_tpu_torch.ops.cuda.flash_prefill, retake_tpu_torch.ops.cuda.pivot_scores\n"
        "import retake_tpu_torch.ops.cuda.vit_attention, retake_tpu_torch.utils.profiling\n"
        "import retake_tpu_torch.ops.cuda.decode_gapped, retake_tpu_torch.runtime.serve\n"
        "import retake_tpu_torch.tools.k4_timing\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'retake_tpu' or m.startswith('retake_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_cuda_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from retake_tpu_torch import device
    from retake_tpu_torch.runtime.engine import Qwen2VLEngine

    with pytest.raises(RuntimeError, match="cuda"):
        device.resolve("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Qwen2VLEngine(tconfig.qwen2_vl_2b(), None, RetakeConfig(), device="cuda")
