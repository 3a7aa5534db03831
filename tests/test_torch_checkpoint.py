"""Weights from disk in the port, against the JAX package on the CPU: a
tiny HF Qwen2-VL checkpoint (one file, and sharded with an index), the
pre-quantized checkpoints both packages write, the port's safetensors
reader and writer against the ``safetensors`` package, ``load_checked``'s
gates, and the port demo's tiny run.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch
import transformers

from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu.models.qwen2_vl import text as jtext
from retake_tpu.models.qwen2_vl.config import Qwen2VLConfig as JaxQwen2VLConfig
from retake_tpu.ops import quantization as jq8
from retake_tpu.runtime import cache as jcache
from retake_tpu.runtime.engine import Qwen2VLEngine as JaxEngine
from retake_tpu.utils import checkpoint as jcheckpoint
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch import demo
from retake_tpu_torch.models.qwen2_vl import params as tparams
from retake_tpu_torch.models.qwen2_vl import text as ttext
from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.runtime import cache as tcache
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.utils import checkpoint, safetensors_io
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import npy, port_cfg, tiny_cfg, video_request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RD = {"longvideo_kwargs": {"chunked_prefill_frames": 2, "frame_chunk_size": 2}}


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """The tiny HF model of tests/test_model_parity.py, saved once whole and
    once in shards with ``model.safetensors.index.json``."""
    hf_cfg = transformers.Qwen2VLConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=4096,
        rope_theta=10000.0, rope_scaling={"type": "mrope", "mrope_section": [4, 2, 2]},
        tie_word_embeddings=False,
        vision_config=dict(depth=2, embed_dim=32, hidden_size=64, mlp_ratio=2, num_heads=2,
                           in_channels=3, patch_size=2, spatial_merge_size=2,
                           temporal_patch_size=2),
        bos_token_id=0, eos_token_id=1, vision_start_token_id=3, vision_end_token_id=4,
        image_token_id=5, video_token_id=6,
    )
    torch.manual_seed(0)
    model = transformers.Qwen2VLForConditionalGeneration(hf_cfg).eval().float()
    root = tmp_path_factory.mktemp("hf")
    whole, sharded = str(root / "whole"), str(root / "sharded")
    model.save_pretrained(whole)
    model.save_pretrained(sharded, max_shard_size="100KB")
    return whole, sharded


def _np(v) -> np.ndarray:
    """A tensor or array as numpy; bf16 as JAX's numpy bf16 (same bits)."""
    if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
        return v.view(torch.int16).numpy().view(np.dtype(jnp.bfloat16))
    return npy(v)


def _leaves(tree, prefix=""):
    """{'/'-joined path: numpy array} of a tree of tensors or arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _np(v)
    return out


def test_hf_checkpoint_loads_to_the_jax_params_and_logits(hf_dir):
    """The whole and the sharded checkpoint: the config and every leaf as
    the JAX loader gives them; a text prompt's logits (fp32, atol 1e-4) and
    one chunked video request's tokens equal to the JAX package's."""
    whole, sharded = hf_dir
    assert os.path.exists(os.path.join(sharded, "model.safetensors.index.json"))
    jcfg = JaxQwen2VLConfig.from_pretrained(whole)
    cfg = Qwen2VLConfig.from_pretrained(whole)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.rope_params()[1] == jcfg.rope_params()[1]
    jp = jparams.load_safetensors(whole, jcfg, dtype=jnp.float32)
    want = _leaves(jp)
    for path in (whole, sharded):
        got = _leaves(tparams.load_safetensors(path, cfg, torch.float32, device="cpu"))
        assert set(got) == set(want)
        for name, leaf in want.items():
            np.testing.assert_array_equal(got[name], leaf, err_msg=name)
    model = Qwen2VLModel(cfg, tparams.load_safetensors(sharded, cfg, torch.float32, device="cpu"))
    np.testing.assert_allclose(_port_logits(cfg, model), _jax_logits(jcfg, jp), atol=1e-4)
    req = video_request(cfg, np.random.default_rng(0), grid_t=4)
    a = JaxEngine(jcfg, jp, JaxRetakeConfig.from_dict(RD)).generate(*req, max_new_tokens=5)
    b = Qwen2VLEngine(cfg, model, RetakeConfig.from_dict(RD), device="cpu").generate(
        *req, max_new_tokens=5)
    np.testing.assert_array_equal(b.tokens, a.tokens)


IDS = np.arange(10, 22)


def _jax_logits(cfg, jp):
    """Logits of the last of 12 text tokens through the JAX decoder."""
    kv = jcache.init_cache(cfg.num_hidden_layers, cfg.num_key_value_heads, 64, cfg.head_dim,
                           dtype=jnp.float32)
    pos = jnp.asarray(np.broadcast_to(np.arange(12, dtype=np.int32), (3, 12)))
    h, _ = jtext.decoder_chunk(jp, cfg, kv, jtext.embed(jp, jnp.asarray(IDS)), pos, jnp.int32(12),
                               jnp.zeros(12, bool), jnp.int32(12), compress=False, reforge=False)
    return np.asarray(jtext.final_logits(jp, cfg, h[-1]))


def _port_logits(cfg, model):
    kv = tcache.init_cache(cfg.num_hidden_layers, cfg.num_key_value_heads, 64, cfg.head_dim,
                           dtype=torch.float32, device="cpu")
    pos = torch.from_numpy(np.broadcast_to(np.arange(12, dtype=np.int32), (3, 12)).copy())
    h, _ = ttext.decoder_chunk(model, cfg, kv, ttext.embed(model, torch.from_numpy(IDS)), pos, 12,
                               torch.zeros(12, dtype=torch.bool), 12, compress=False,
                               reforge=False)
    return npy(ttext.final_logits(model, cfg, h[-1]))


def test_from_torch_model_matches_jax(hf_dir):
    """``from_torch_model`` of the live model == the JAX converter's."""
    whole, _ = hf_dir
    model = transformers.Qwen2VLForConditionalGeneration.from_pretrained(whole).eval()
    jcfg = JaxQwen2VLConfig.from_pretrained(whole)
    want = _leaves(jparams.from_torch_model(jcfg, model, dtype=jnp.float32))
    got = _leaves(tparams.from_torch_model(Qwen2VLConfig.from_pretrained(whole), model,
                                           torch.float32, device="cpu"))
    assert set(got) == set(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(got[name], leaf, err_msg=name)


def _quantized_bf16_tree():
    """A bf16 tree with int8 linears, embedding and head and fp32 scales
    (the leaves ``tools/quantize_checkpoint.py`` writes), the JAX way."""
    cfg = tiny_cfg()
    tree = jq8.quantize_llm_int8(jparams.init_params(cfg, seed=0, dtype=jnp.bfloat16))
    tree["visual"] = jq8.quantize_vit_int8(tree["visual"])
    return cfg, tree


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pre_quantized_checkpoints_cross_load(tmp_path, writer):
    """A JAX ``save_params`` checkpoint loads into the port and a port one
    into JAX: every leaf byte-identical (bf16, int8, fp32) and the same
    keys; then a request through each side's loaded tree gives the same
    tokens."""
    cfg, jtree = _quantized_bf16_tree()
    ttree = tparams.from_jax_params(jax.tree.map(np.asarray, jtree))
    out = str(tmp_path / "ckpt")
    meta = {"model_name": "qwen2_vl", "weights": "int8"}
    if writer == "jax":
        jcheckpoint.save_params(jtree, out, meta=meta)
    else:
        checkpoint.save_params(ttree, out, meta=meta)
    assert checkpoint.has_params(out) and checkpoint.load_meta(out) == meta
    got = _leaves(checkpoint.load_params(out, device="cpu"))
    back = _leaves(jcheckpoint.load_params(out, device=False))
    want = _leaves(jtree)
    assert set(got) == set(back) == set(want)
    for name, leaf in want.items():
        for other in (got[name], back[name]):
            assert other.dtype == leaf.dtype and other.shape == leaf.shape, name
            assert other.tobytes() == leaf.tobytes(), name
    loaded = checkpoint.load_checked(out, RetakeConfig.from_dict({"quantization": "int8"}),
                                     "qwen2_vl", device="cpu")
    rd = dict(RD, quantization="int8")
    req = video_request(cfg, np.random.default_rng(1), grid_t=2)
    a = Qwen2VLEngine(port_cfg(cfg), Qwen2VLModel(port_cfg(cfg), loaded),
                      RetakeConfig.from_dict(rd), device="cpu").generate(*req, max_new_tokens=4)
    b = Qwen2VLEngine(port_cfg(cfg), Qwen2VLModel(port_cfg(cfg), ttree),
                      RetakeConfig.from_dict(rd), device="cpu").generate(*req, max_new_tokens=4)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.first_logits, b.first_logits)


@pytest.mark.parametrize("meta,rd,match", [
    ({"model_name": "llava_video"}, {"quantization": "int8"}, "quantized for model_name"),
    ({"model_name": "qwen2_vl"}, {}, "holds int8 weights"),
    ({"model_name": "qwen2_vl"}, {"quantization": "w8a8"}, "quantized with --vit"),
])
def test_load_checked_raises_where_jax_raises(tmp_path, meta, rd, match):
    out = str(tmp_path / "ckpt")
    checkpoint.save_params({"final_ln": torch.ones(4)}, out, meta=meta)
    with pytest.raises(ValueError, match=match):
        jcheckpoint.load_checked(out, JaxRetakeConfig.from_dict(rd), "qwen2_vl")
    with pytest.raises(ValueError, match=match):
        checkpoint.load_checked(out, RetakeConfig.from_dict(rd), "qwen2_vl", device="cpu")


def _sample_tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "f32": torch.randn(7, generator=g),
        "i8": torch.randint(-127, 128, (2, 3, 4), generator=g).to(torch.int8),
        "empty": torch.zeros(0, 4),
        "scalar": torch.tensor(2.5),
    }


def test_safetensors_io_against_the_package(tmp_path):
    """The port's writer read by the package and the package's writer read
    by the port: bf16, f32, int8, a zero-size and a 0-d tensor; metadata."""
    tensors = _sample_tensors()
    mine, theirs = str(tmp_path / "mine.safetensors"), str(tmp_path / "theirs.safetensors")
    safetensors_io.save_file(tensors, mine, metadata={"format": "pt"})
    safetensors.torch.save_file(tensors, theirs, metadata={"format": "pt"})
    for path in (mine, theirs):
        for name, got in safetensors.torch.load_file(path).items():
            assert got.dtype == tensors[name].dtype and torch.equal(got, tensors[name]), name
        loaded = safetensors_io.load_file(path)
        assert set(loaded) == set(tensors)
        for name, got in loaded.items():
            assert got.dtype == tensors[name].dtype and torch.equal(got, tensors[name]), name
        assert safetensors_io.SafeFile(path).metadata == {"format": "pt"}


def test_processor_from_pretrained_reads_a_tokenizer(tmp_path):
    """``from_pretrained`` loads the HF tokenizer saved beside a checkpoint
    (a word-level tokenizer built here) and the prompt uses it."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    from retake_tpu_torch.data.processor import LlavaOnevisionVideoProcessor, Qwen2VLProcessor

    vocab = {"[UNK]": 0, "why": 1, "?": 2}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]").save_pretrained(
        str(tmp_path))
    for proc in (Qwen2VLProcessor.from_pretrained(str(tmp_path)),
                 LlavaOnevisionVideoProcessor.from_pretrained(str(tmp_path))):
        assert isinstance(proc.tokenizer, transformers.PreTrainedTokenizerFast)
        assert 1 in proc("why")["input_ids"]


def test_demo_tiny_runs_on_the_cpu(capsys, tmp_path):
    """``python3 -m retake_tpu_torch.demo --tiny --device cpu --json`` over
    configs/retake_demo.yaml with 8 new tokens: the tiny model, vision and
    the prefix encoded once, three answers of 8 tokens."""
    with open(os.path.join(REPO, "configs", "retake_demo.yaml")) as f:
        text = f.read()
    cfg = tmp_path / "demo.yaml"
    cfg.write_text(text + "\nmax_new_tokens: 8\n")
    assert demo.main(["--tiny", "--device", "cpu", "--json", "--frames", "4",
                      "--config", str(cfg)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["expected"] == ["A", "B", "C"] and len(out["tokens"]) == 3
    assert all(1 <= len(t) <= 8 for t in out["tokens"])
    assert any("encoded once" in line for line in lines)
