"""The port's checkpoint quantizer (``retake_tpu_torch/tools/quantize_checkpoint.py``)
against the JAX package's ``tools/quantize_checkpoint.py`` on the CPU.

Both tools quantize a tiny saved HF checkpoint (Qwen2-VL with and without
``--vit``; LLaVA-Video with ``--vit``). Their outputs must hold the same
files, the same sidecar and the same tree: keys, dtypes and shapes. The
JAX tool run op by op (``jax.disable_jit``) writes every leaf byte for byte
as the port's. The JAX tool as it ships jits its quantizers, and a jitted
quantizer multiplies by 1/127 where the op-by-op function (and the port)
divides by 127, which moves some per-channel scales by one ulp (ROADMAP
Queue 3, "Kept as not faults"). Against that run the differing scale
elements are counted, each must be one ulp apart, and an int8 weight may
differ only by one step in a channel whose scale moved.
Then the eval runner's ``_load_engine`` takes the port tool's output
through its pre-quantized branch: the engine holds the written tree.
"""

import importlib.util
import json
import os
import sys

import jax
import pytest
import torch
import transformers

from retake_tpu_torch.eval import infer_eval as teval
from retake_tpu_torch.eval.synthetic import save_offline_tokenizer
from retake_tpu_torch.tools import quantize_checkpoint as ttool
from retake_tpu_torch.utils import checkpoint
from retake_tpu_torch.utils.config import RetakeConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_quantize_checkpoint", os.path.join(REPO, "tools", "quantize_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """Tiny HF Qwen2-VL and LLaVA-OneVision checkpoints with tokenizer files."""
    root = tmp_path_factory.mktemp("hf")
    qwen = transformers.Qwen2VLConfig(
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
    llava = transformers.LlavaOnevisionConfig(
        text_config=dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=4096, rope_theta=10000.0,
                         tie_word_embeddings=False, bos_token_id=0, eos_token_id=1,
                         model_type="qwen2"),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, image_size=16, patch_size=4,
                           model_type="siglip_vision_model", vision_use_head=False),
        image_token_index=5, video_token_index=6, vision_feature_select_strategy="full",
        vision_feature_layer=-1,
    )
    dirs = {}
    torch.manual_seed(0)
    for name, model in (
            ("qwen2_vl", transformers.Qwen2VLForConditionalGeneration(qwen)),
            ("llava_video", transformers.LlavaOnevisionForConditionalGeneration(llava))):
        path = str(root / name)
        model.eval().float().save_pretrained(path)
        save_offline_tokenizer(path)
        dirs[name] = path
    return dirs


def _leaves(path):
    f = checkpoint.safetensors_io.SafeFile(os.path.join(path, checkpoint.FILENAME))
    return {k: f.tensor(k) for k in f.keys()}


def _ulps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place of fp32 (same-sign values)."""
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


@pytest.mark.parametrize("model_name,vit", [("qwen2_vl", False), ("qwen2_vl", True),
                                            ("llava_video", True)])
def test_port_tool_writes_the_jax_tools_checkpoint(hf_dirs, tmp_path, monkeypatch, capsys,
                                                   model_name, vit):
    hf = hf_dirs[model_name]
    outs = {who: str(tmp_path / who) for who in ("jax", "jax_op_by_op", "port")}
    flags = ["--hf_path", hf, "--model_name", model_name] + (["--vit"] if vit else [])
    for who in ("jax", "jax_op_by_op"):
        monkeypatch.setattr(sys, "argv", ["quantize_checkpoint.py", "--out", outs[who]] + flags)
        if who == "jax":
            _jax_tool().main()
        else:
            with jax.disable_jit():
                _jax_tool().main()
    assert ttool.main(["--out", outs["port"], "--device", "cpu"] + flags) == 0
    printed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()[-3:]]
    assert [p["out"] for p in printed] == list(outs.values())
    assert all(p["files"] == sorted(os.listdir(outs["port"])) for p in printed)

    # the same files: tree, sidecar, config and tokenizer copies
    for fname in ttool.COPIED_FILES + (checkpoint.META_FILENAME,):
        paths = [os.path.join(outs[w], fname) for w in ("jax", "port")]
        assert os.path.exists(paths[0]) == os.path.exists(paths[1]), fname
        if os.path.exists(paths[0]):
            with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
                assert a.read() == b.read(), fname
    assert checkpoint.load_meta(outs["port"]) == {
        "model_name": model_name, "weights": "int8", "vit_int8": vit, "source": hf}

    got = _leaves(outs["port"])
    op_by_op = _leaves(outs["jax_op_by_op"])
    assert set(op_by_op) == set(got)
    for key, w in op_by_op.items():
        assert got[key].dtype == w.dtype and torch.equal(got[key], w), key

    jitted = _leaves(outs["jax"])
    assert set(jitted) == set(got)
    moved, n_scales = 0, 0
    for key, w in jitted.items():
        g = got[key]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), key
        wkey = key[: -len("scale")] + "w"
        if not (key.endswith("/scale") and jitted.get(wkey, w).dtype == torch.int8):
            if jitted.get(key[: -len("w")] + "scale") is None or not key.endswith("/w"):
                assert torch.equal(g, w), key  # not a quantizer's output
            continue
        n_scales += w.numel()
        ulps = _ulps_apart(g, w)
        assert int(ulps.max()) <= 1, (key, int(ulps.max()))
        moved += int((ulps == 1).sum())
        # the int8 weights beside a scale: one step apart at most, and only
        # in a channel whose scale moved (scale [..., out] / [rows])
        diff = (got[wkey].int() - jitted[wkey].int()).abs()
        assert int(diff.max()) <= 1, wkey
        if key.startswith("embed_tokens"):  # per-row scale [V], w [V, d]
            channel_moved = (ulps == 1)[:, None]
        else:  # per-output-channel scale [..., out], w [..., in, out]
            channel_moved = (ulps == 1).unsqueeze(-2)
        assert not bool(((diff > 0) & ~channel_moved).any()), wkey
    print(f"{model_name} vit={vit}: {moved} of {n_scales} scale elements one ulp apart from "
          "the jitted JAX tool's (its 1/127); op by op every leaf is equal")


def test_eval_loader_takes_the_quantized_tree(hf_dirs, tmp_path):
    """``infer_eval._load_engine`` on the port tool's ``--vit`` output under
    a W8A8 config (the directory holds no HF weights, so only the
    pre-quantized branch can load it): the engine's model equals one built
    from the written tree, and a config without int8 weights is refused."""
    from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig
    from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel

    out = str(tmp_path / "q")
    ttool.main(["--hf_path", hf_dirs["qwen2_vl"], "--out", out, "--vit", "--device", "cpu"])
    engine = teval._load_engine("qwen2_vl", out, RetakeConfig.from_dict({"quantization": "w8a8"}),
                                "cpu")
    want = dict(Qwen2VLModel(Qwen2VLConfig.from_pretrained(out),
                             checkpoint.load_params(out, device="cpu")).named_parameters())
    held = dict(engine.model.named_parameters())
    assert set(held) == set(want) and engine.model.int8 and engine.act_quant
    for name, p in want.items():
        assert held[name].dtype == p.dtype and torch.equal(held[name], p), name
    with pytest.raises(ValueError, match="holds int8 weights"):
        teval._load_engine("qwen2_vl", out, RetakeConfig(), "cpu")
