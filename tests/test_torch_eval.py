"""The port's eval runner (``retake_tpu_torch/eval/infer_eval.py``) and its
jax-free data copies (``data/datasets.py``, ``data/scorers.py``) against the
JAX package on the CPU, fp32, the same weights and inputs.

A synthetic Video-MME benchmark (4 videos of 12 JPEG frames, 6 questions,
``retake_tpu_torch/eval/synthetic.py``) goes through both runners' two
ranks and rank-0 merge: every sample's generated token ids, the journals
(every key but the timings) and ``anno_id2result.json``,
``infer_results.csv`` and ``eval_results.csv`` must be equal, the files
byte for byte, with ``eval_batch_size`` 1 and 2 and
``reuse_video_features`` off and on (the same reuse summary). The answers
alone would not show the tokens (a tokenizer's decode and ``trim_answer``
keep one letter at most), so each run records the ids it decodes. Frames
take each package's default path (the native decoder and patchify where
they build, bit-identical across the packages: tests/test_torch_native.py),
so both runners see the same pixels. Also: a shard half-written by one runner resumed by the
other; the LLaVA branch of ``_load_engine``; the CLI's ``main`` on a tiny
saved HF checkpoint with a tokenizer built offline, in this process and
as two OS processes joined by ``gloo``; the copies' scorers and dataset on
the cases of tests/test_data.py.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import transformers

from retake_tpu.data import datasets as jdatasets
from retake_tpu.data import processor as jproc
from retake_tpu.data import scorers as jscorers
from retake_tpu.eval import infer_eval as jeval
from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu.models.qwen2_vl.config import Qwen2VisionConfig, Qwen2VLConfig
from retake_tpu.runtime.engine import Qwen2VLEngine as JaxEngine
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.data import datasets as tdatasets
from retake_tpu_torch.data import processor as tproc
from retake_tpu_torch.data import scorers as tscorers
from retake_tpu_torch.eval import infer_eval as teval
from retake_tpu_torch.eval.synthetic import free_port, save_offline_tokenizer, write_videomme
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import TINY, port_cfg, port_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = ("anno_id2result.json", "infer_results.csv", "eval_results.csv")
# (eval_batch_size, reuse_video_features)
CASES = [(1, False), (2, False), (1, True), (2, True)]
QUESTIONS = (2, 1, 2, 1)  # per video: 6 samples
DATA_KW = dict(video_fps=4, video_maxlen=8, image_resolution=84,
               # 12-frame clips: extraction fps 2 -> 8 sampled frames
               video_frame_extraction_fps=2)
TOKEN_IDS = dict(vision_start_token_id=3, vision_end_token_id=4, video_token_id=6,
                 image_token_id=5)


class StubTokenizer:
    """Encodes bytes; decodes to a letter picked from the ids, and keeps
    every id list it decodes, in the order the runner journals them."""

    def __init__(self):
        self.decoded = []

    def encode(self, s):
        return [20 + (b % 400) for b in s.encode()][:64]

    def decode(self, ids, **kw):
        self.decoded.append([int(t) for t in ids])
        return "ABCD"[int(sum(ids)) % 4]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return write_videomme(str(tmp_path_factory.mktemp("videomme")), QUESTIONS, 12, 84, 56)


@pytest.fixture(scope="module")
def tiny():
    """The tiny Qwen2-VL of tests/test_eval_harness.py (ViT patch 14) with
    its special ids inside the 512-token vocabulary; JAX fp32 weights and
    the port's model over the same values."""
    cfg = Qwen2VLConfig(**TINY, vision=Qwen2VisionConfig(
        depth=2, embed_dim=32, hidden_size=64, mlp_ratio=2, num_heads=2))
    jp = jparams.init_params(cfg, seed=0, dtype=jnp.float32)
    return cfg, jp, Qwen2VLModel(port_cfg(cfg), port_params(jp))


def _rd(out_dir, bs, reuse):
    return {"dataset_name": "videomme", "max_new_tokens": 4, "eval_batch_size": bs,
            "reuse_video_features": reuse, "output_dir": out_dir,
            "longvideo_kwargs": {"chunked_prefill_frames": 4, "frame_chunk_size": 4}}


def _processor(mod, cfg, tok):
    return mod.Qwen2VLProcessor(tok, patch_size=cfg.vision.patch_size,
                                merge_size=cfg.vision.spatial_merge_size,
                                temporal_patch_size=cfg.vision.temporal_patch_size,
                                min_pixels=1, **TOKEN_IDS)


def _records(out_dir, rank):
    """A shard's journal records without their timings ([] before it exists)."""
    path = os.path.join(out_dir, f"shard_{rank:03d}.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    for rec in recs:
        rec["metrics"] = {k: v for k, v in rec["metrics"].items() if not k.endswith("_s")}
    return recs


@contextlib.contextmanager
def _ids_journaled(out_dir, ranks, decoded):
    """Yields a dict that, after the block, maps each sample the block
    journaled in ``out_dir`` to its generated ids. A runner decodes each
    result just before it journals it, and runs its ranks here in turn, so
    the ids ``decoded`` gains pair in order with the new records."""
    before = {rank: len(_records(out_dir, rank)) for rank in ranks}
    start = len(decoded)
    ids = {}
    yield ids
    recs = [rec for rank in ranks for rec in _records(out_dir, rank)[before[rank]:]]
    assert len(recs) == len(decoded) - start
    ids.update((rec["idx"], d) for rec, d in zip(recs, decoded[start:]))


def _run_jax(tiny, anno_file, rd, ranks=(0, 1), world=2, merge=True):
    """The JAX runner's ranks (and merge) on one process: its stdout and
    each journaled sample's ids."""
    cfg, jp, _ = tiny
    rt = JaxRetakeConfig.from_dict(rd)
    engine = JaxEngine(cfg, jp, rt)
    dataset = jdatasets.BaseDataset(anno_file, processor_kwargs=DATA_KW)
    tok = StubTokenizer()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            _ids_journaled(rd["output_dir"], ranks, tok.decoded) as ids:
        for rank in ranks:
            jeval.run_eval(engine, _processor(jproc, cfg, tok), dataset, rt, rank, world)
        if merge:
            jeval.merge_and_score(rt, world)
    return out.getvalue(), ids


def _run_port(tiny, anno_file, rd, ranks=(0, 1), world=2, merge=True, engine="new"):
    cfg, _, model = tiny
    rt = RetakeConfig.from_dict(rd)
    if engine == "new":
        engine = Qwen2VLEngine(port_cfg(cfg), model, rt, device="cpu")
    dataset = tdatasets.BaseDataset(anno_file, processor_kwargs=DATA_KW)
    tok = StubTokenizer()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            _ids_journaled(rd["output_dir"], ranks, tok.decoded) as ids:
        done = {}
        for rank in ranks:
            done.update(teval.run_eval(engine, _processor(tproc, cfg, tok), dataset, rt, rank,
                                       world))
        if merge:
            teval.merge_and_score(rt, world)
    return done, out.getvalue(), ids


@pytest.fixture(scope="module")
def jax_runs(tiny, bench, tmp_path_factory):
    """The JAX runner's output directory, stdout and ids for every case, once."""
    runs = {}
    for bs, reuse in CASES:
        out_dir = str(tmp_path_factory.mktemp(f"jax_bs{bs}_reuse{int(reuse)}"))
        runs[(bs, reuse)] = (out_dir, *_run_jax(tiny, bench, _rd(out_dir, bs, reuse)))
    return runs


def _assert_same_outputs(got_dir, want_dir, world=2):
    for rank in range(world):
        assert _records(got_dir, rank) == _records(want_dir, rank), rank
    for name in ARTIFACTS:
        with open(os.path.join(got_dir, name), "rb") as g, open(os.path.join(want_dir, name),
                                                                  "rb") as w:
            assert g.read() == w.read(), name


def _read(path):
    with open(path) as f:
        return f.read()


def _summaries(stdout):
    return [line for line in stdout.splitlines() if "prefix reuse summary" in line]


@pytest.mark.parametrize("bs,reuse", CASES)
def test_eval_matches_the_jax_runner(tiny, bench, jax_runs, tmp_path, bs, reuse):
    """Two ranks and the merge: every sample's ids, the journals and the
    artifacts byte for byte; under reuse one vision encode per video and
    the same reuse summary."""
    want_dir, want_out, want_ids = jax_runs[(bs, reuse)]
    got_dir = str(tmp_path / "port")
    done, got_out, got_ids = _run_port(tiny, bench, _rd(got_dir, bs, reuse))
    assert sorted(done) == sorted(want_ids) == list(range(sum(QUESTIONS)))
    assert got_ids == want_ids
    _assert_same_outputs(got_dir, want_dir)
    assert _summaries(got_out) == _summaries(want_out)
    if reuse:
        # rank 0 owns videos 0 and 2, rank 1 videos 1 and 3; every question
        # reuses its video's captured prefix
        assert _summaries(got_out) == [
            "[rank 0] prefix reuse summary: reused=4, mismatch=0, capture_failed=0, "
            "unsupported=0",
            "[rank 1] prefix reuse summary: reused=2, mismatch=0, capture_failed=0, "
            "unsupported=0"]
    # resume: every sample is journaled, nothing runs (no engine needed)
    again, _, ran = _run_port(tiny, bench, _rd(got_dir, bs, reuse), merge=False, engine=None)
    assert again == done and not ran


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_the_two_runners(tiny, bench, jax_runs, tmp_path, writer):
    """One runner journals rank 0's first sample and rank 1 whole; the
    other resumes rank 0; the resumed samples' ids and the merged artifacts
    equal the JAX runner's uninterrupted run."""
    want_dir, _, want_ids = jax_runs[(1, False)]
    out_dir = str(tmp_path / "resumed")
    os.makedirs(out_dir)
    if writer == "jax":
        src = want_dir
    else:
        src = str(tmp_path / "port")
        _run_port(tiny, bench, _rd(src, 1, False), merge=False)
    with open(os.path.join(src, "shard_000.jsonl")) as f:
        first = f.readline()
    with open(os.path.join(out_dir, "shard_000.jsonl"), "w") as f:
        f.write(first)
    shutil.copy(os.path.join(src, "shard_001.jsonl"), out_dir)
    rd = _rd(out_dir, 1, False)
    if writer == "jax":
        *_, ids = _run_port(tiny, bench, rd, ranks=(0,))
    else:
        _, ids = _run_jax(tiny, bench, rd, ranks=(0,))
    assert sorted(ids) == list(range(2, sum(QUESTIONS), 2))
    assert ids == {i: want_ids[i] for i in ids}
    _assert_same_outputs(out_dir, want_dir)


def test_prefetch_iter_matches_the_original():
    """In order, with and without loader threads, as the JAX runner's."""
    idxs = list(range(9))
    for workers in (0, 2):
        got = list(teval.prefetch_iter(idxs, lambda i: i * 10, workers))
        assert got == list(jeval.prefetch_iter(idxs, lambda i: i * 10, workers))
        assert got == [(i, i * 10) for i in idxs]


def test_json_safe_matches_the_original():
    obj = {"a": np.int64(3), "b": [np.float32(0.5), (np.int8(1), "x")], "c": None}
    assert teval._json_safe(obj) == jeval._json_safe(obj) == {"a": 3, "b": [0.5, [1, "x"]],
                                                              "c": None}


def test_process_device_and_the_card_default():
    """``cuda`` is the process's own card; without CUDA it raises, and the
    CPU runs only when named."""
    assert teval.process_device("cpu", 3) == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        teval.process_device("cuda", 0)
    assert teval.parse_args(["--hf_path", "x", "--config_path", "y"]).device == "cuda"


# ---------------------------------------------------------------- from disk


@pytest.fixture(scope="module")
def hf_qwen(tmp_path_factory):
    """A tiny Qwen2-VL as a saved HF checkpoint with an offline tokenizer.
    ``main`` builds its processor with ``from_pretrained``'s default special
    ids (Qwen2-VL's), so the vocabulary is Qwen2-VL's size."""
    hf_cfg = transformers.Qwen2VLConfig(
        vocab_size=151936, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=4096,
        rope_theta=10000.0, rope_scaling={"type": "mrope", "mrope_section": [4, 2, 2]},
        tie_word_embeddings=False,
        vision_config=dict(depth=2, embed_dim=32, hidden_size=64, mlp_ratio=2, num_heads=2,
                           in_channels=3, patch_size=14, spatial_merge_size=2,
                           temporal_patch_size=2),
    )
    torch.manual_seed(0)
    model = transformers.Qwen2VLForConditionalGeneration(hf_cfg).eval().float()
    path = str(tmp_path_factory.mktemp("hf_qwen"))
    model.save_pretrained(path)
    save_offline_tokenizer(path)
    return path


def _cli_argv(hf_path, root, out_dir, anno_file):
    """The CLI's flags over a YAML config written into ``root``."""
    cfg_path = os.path.join(root, os.path.basename(out_dir) + ".yaml")
    with open(cfg_path, "w") as f:
        json.dump({**_rd(out_dir, 2, False), "anno_file": anno_file,
                   "longsize_resolution": 84, "max_num_frames": 8}, f)
    return ["--hf_path", hf_path, "--config_path", cfg_path, "--video_frame_extraction_fps", "2"]


def _record_decodes(mp, mod, decoded):
    """``mod``'s Qwen2VLProcessor keeps every id list it decodes."""
    decode = mod.Qwen2VLProcessor.decode

    def recording(self, token_ids):
        decoded.append([int(t) for t in token_ids])
        return decode(self, token_ids)

    mp.setattr(mod.Qwen2VLProcessor, "decode", recording)


@pytest.fixture(scope="module")
def jax_cli(hf_qwen, bench, tmp_path_factory):
    """The JAX runner's ``main`` over the saved checkpoint (bf16 weights, as
    both loaders read them), once: its output directory and ids."""
    root = str(tmp_path_factory.mktemp("jax_cli"))
    out_dir = os.path.join(root, "jax")
    decoded = []
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()), \
            _ids_journaled(out_dir, (0,), decoded) as ids:
        _record_decodes(mp, jproc, decoded)
        mp.setattr(sys, "argv", ["infer_eval"] + _cli_argv(hf_qwen, root, out_dir, bench))
        jeval.main()
    return out_dir, ids


def test_cli_main_matches_the_jax_runner(hf_qwen, bench, jax_cli, tmp_path, monkeypatch, capsys):
    """``python3 -m retake_tpu_torch.eval.infer_eval --device cpu`` over a
    YAML config, the saved checkpoint and its tokenizer: the JAX runner's
    ``main`` ids and artifacts."""
    want_dir, want_ids = jax_cli
    out_dir = str(tmp_path / "port")
    decoded = []
    _record_decodes(monkeypatch, tproc, decoded)
    with _ids_journaled(out_dir, (0,), decoded) as ids:
        assert teval.main(_cli_argv(hf_qwen, str(tmp_path), out_dir, bench)
                          + ["--device", "cpu"]) == 0
    capsys.readouterr()
    assert sorted(ids) == list(range(sum(QUESTIONS)))
    assert ids == want_ids
    _assert_same_outputs(out_dir, want_dir, world=1)


def test_two_processes_through_gloo(hf_qwen, bench, jax_cli, tmp_path):
    """The CLI as two OS processes (``--device cpu --coordinator
    127.0.0.1:<port> --num_processes 2``): each joins the ``gloo`` group
    through ``_init_distributed``, evaluates its round-robin shard and waits
    at the barrier; rank 0 merges. The merged files hold the JAX runner's
    one-process results: ``eval_results.csv`` byte for byte, the other two
    in the merge's order (rank 0's samples, then rank 1's)."""
    out_dir = str(tmp_path / "multi")
    argv = _cli_argv(hf_qwen, str(tmp_path), out_dir, bench) + [
        "--device", "cpu", "--coordinator", f"127.0.0.1:{free_port()}", "--num_processes", "2"]
    # the two processes share this host's cores
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "retake_tpu_torch.eval.infer_eval", *argv, "--process_id", str(k)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(2)]
    try:
        outs = [pr.communicate(timeout=300)[0] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    assert [pr.returncode for pr in procs] == [0, 0], outs
    n = sum(QUESTIONS)
    shards = [sorted(rec["idx"] for rec in _records(out_dir, k)) for k in range(2)]
    assert shards == [list(range(0, n, 2)), list(range(1, n, 2))]
    order = shards[0] + shards[1]
    got, want = ({name: _read(os.path.join(d, name)) for name in ARTIFACTS}
                 for d in (out_dir, jax_cli[0]))
    assert got["eval_results.csv"] == want["eval_results.csv"]
    assert list(json.loads(got["anno_id2result.json"])) == [str(i) for i in order]
    assert json.loads(got["anno_id2result.json"]) == json.loads(want["anno_id2result.json"])
    got_rows, want_rows = (f["infer_results.csv"].splitlines() for f in (got, want))
    assert got_rows == want_rows[:1] + [want_rows[1 + i] for i in order]


def test_llava_branch_of_load_engine(bench, tmp_path, capsys):
    """``_load_engine`` for ``llava_video``: the tiny HF LLaVA-OneVision
    saved with ``save_pretrained``, read by both runners' loaders (bf16);
    the two-rank run's ids, journals and artifacts equal the JAX runner's."""
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
    path = str(tmp_path / "llava")
    transformers.LlavaOnevisionForConditionalGeneration(hf_cfg).eval().float().save_pretrained(
        path)
    outs, ids = {}, {}
    for who, ev, pmod, ds, rcls in (
            ("jax", jeval, jproc, jdatasets, JaxRetakeConfig),
            ("port", teval, tproc, tdatasets, RetakeConfig)):
        out_dir = str(tmp_path / who)
        rt = rcls.from_dict({**_rd(out_dir, 2, False), "model_name": "llava_video"})
        if who == "jax":
            engine = ev._load_engine(None, path, rt)
        else:
            engine = ev._load_engine(None, path, rt, "cpu")
        tok = StubTokenizer()
        proc = pmod.LlavaOnevisionVideoProcessor(
            tok, video_token_id=6, image_token_id=5,
            image_size=engine.cfg.vision.image_size, patch_size=engine.cfg.vision.patch_size,
            tokens_per_frame=engine.cfg.tokens_per_frame)
        dataset = ds.BaseDataset(bench, processor_kwargs=DATA_KW)
        with _ids_journaled(out_dir, (0, 1), tok.decoded) as ids[who]:
            for rank in (0, 1):
                ev.run_eval(engine, proc, dataset, rt, rank, 2)
            ev.merge_and_score(rt, 2)
        outs[who] = out_dir
    capsys.readouterr()
    assert sorted(ids["port"]) == list(range(sum(QUESTIONS)))
    assert ids["port"] == ids["jax"]
    _assert_same_outputs(outs["port"], outs["jax"])


# ---------------------------------------------------------------- the copies


@pytest.mark.parametrize("s", [
    "The best answer is B.", "  C", "I think the answer is (D)", "no letter here at all " * 5,
    "", "Best option: (E) because", "The correct option is g", "a b c d e f g h i j k A"])
def test_trim_answer_copy_matches(s):
    assert tscorers.trim_answer(s) == jscorers.trim_answer(s)


def _assert_frames_equal(got, want):
    for g, w in zip(got, want):
        pd.testing.assert_frame_equal(g, w)
        assert g.to_csv() == w.to_csv()


def test_videomme_scorer_copy_matches():
    results = {i: "A" for i in range(6)}
    metas = {i: dict(answer="A" if i % 2 == 0 else "B", task_type="t1" if i < 3 else "t2",
                     domain="d", duration=["short", "medium", "long"][i % 3])
             for i in range(6)}
    _assert_frames_equal(tscorers.eval_videomme_results(results, metas),
                         jscorers.eval_videomme_results(results, metas))


def test_mlvu_scorer_copy_matches():
    """The dev split, the test split (SportsQA and Tutorial QA join M-AVG)
    and the raise on an unknown type, as tests/test_data.py's cases."""
    metas, results = {}, {}
    i = 0
    for qt in jscorers.MLVU_MC_TYPES + jscorers.MLVU_GEN_TYPES:
        for correct in (True, False):
            metas[i] = dict(answer="A", question_type=qt)
            results[i] = "A" if correct else "B"
            i += 1
    _assert_frames_equal(tscorers.eval_mlvu_results(results, metas),
                         jscorers.eval_mlvu_results(results, metas))
    for qt in ("SportsQA", "Tutorial QA"):
        metas[i] = dict(answer="A", question_type=qt)
        results[i] = "A"
        i += 1
    _assert_frames_equal(tscorers.eval_mlvu_results(results, metas),
                         jscorers.eval_mlvu_results(results, metas))
    metas[i] = dict(answer="A", question_type="Mystery QA")
    results[i] = "A"
    with pytest.raises(ValueError, match="Mystery QA"):
        tscorers.eval_mlvu_results(results, metas)
    for name in ("MLVU_MC_TYPES", "MLVU_GEN_TYPES", "MLVU_DEV_ORDER", "MLVU_TEST_MC_TYPES",
                 "MLVU_TEST_ORDER", "LVBENCH_ORDER"):
        assert getattr(tscorers, name) == getattr(jscorers, name), name


def test_lvbench_scorer_copy_matches():
    results = {0: "A", 1: "B", 2: "C"}
    metas = {0: dict(answer="A", question_type=["reasoning", "summarization"]),
             1: dict(answer="A", question_type=["reasoning"]),
             2: dict(answer="C", question_type=["entity recognition"])}
    _assert_frames_equal(tscorers.eval_lvbench_results(results, metas),
                         jscorers.eval_lvbench_results(results, metas))


def test_get_eval_methods_and_dataset_copies_match(bench):
    for name in ("videomme", "MLVU", "LVBench"):
        assert (tscorers.get_eval_methods(name).__name__
                == jscorers.get_eval_methods(name).__name__)
    with pytest.raises(NotImplementedError):
        tscorers.get_eval_methods("egoschema")
    with pytest.raises(NotImplementedError):
        tdatasets.get_dataset("egoschema", bench, DATA_KW)
    got = tdatasets.get_dataset("videomme", bench, DATA_KW)
    want = jdatasets.get_dataset("videomme", bench, DATA_KW)
    assert len(got) == len(want) == sum(QUESTIONS)
    for i in range(len(want)):
        assert got.video_key(i) == want.video_key(i)
        assert got.item_light(i) == want.item_light(i)
        gi, gmsg, gmeta = got[i]
        wi, wmsg, wmeta = want[i]
        assert (gi, gmsg["question"], gmeta) == (wi, wmsg["question"], wmeta)
        assert len(gmsg["video"]) == len(wmsg["video"]) == 8
        for g, w in zip(gmsg["video"], wmsg["video"]):
            np.testing.assert_array_equal(g, w)
