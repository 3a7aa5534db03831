"""The port's sampler (``runtime/sampling.py``) and sampled decode against
the JAX engine on the CPU, fp32.

torch's generator cannot reproduce JAX's random stream, so the draws are
held exactly by feeding the port JAX's own Gumbel noise
(``jax.random.gumbel`` under the JAX engine's key schedule) through the
sampler's ``noise_fn``: ``jax.random.categorical`` is ``argmax(logits +
that noise)``. With the port's own noise, sampled ``generate_batch`` and the
sampled server are held to the port's sequential ``generate``.

Tolerances: the filtered logits keep the same -inf mask and their finite
values within 1e-6 relative; tokens exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retake_tpu.models.qwen2_vl import params as jparams
from retake_tpu.runtime import engine as jengine
from retake_tpu.runtime.engine import Qwen2VLEngine as JaxEngine
from retake_tpu.utils.config import RetakeConfig as JaxRetakeConfig
from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel
from retake_tpu_torch.runtime import sampling
from retake_tpu_torch.runtime.engine import Qwen2VLEngine
from retake_tpu_torch.runtime.serve import ContinuousServer
from retake_tpu_torch.utils.config import RetakeConfig
from torch_parity import port_cfg, port_params, tiny_cfg, video_request

CHUNKED = {"chunked_prefill_frames": 2, "frame_chunk_size": 2}


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg()
    jp = jparams.init_params(cfg, seed=0, dtype=jnp.float32)
    return cfg, jp, Qwen2VLModel(port_cfg(cfg), port_params(jp))


def jax_key(seed, stream, step):
    """The JAX engine's key for a draw: fold_in(key(seed), 0) for the first
    token, fold_in(fold_in(key(seed), 1), step) for decode step ``step``."""
    key = jax.random.fold_in(jax.random.key(seed), stream)
    return jax.random.fold_in(key, step) if stream == sampling.LOOP else key


def jax_noise(seed, stream, step, vocab, device):
    g = jax.random.gumbel(jax_key(seed, stream, step), (vocab,), jnp.float32)
    return torch.from_numpy(np.array(g)).to(device)


def jax_filtered(logits, temperature, top_p, top_k):
    """The logits ``_select_token`` hands to ``jax.random.categorical``."""
    seen = {}
    real = jax.random.categorical

    def capture(key, x, *a, **kw):
        seen["x"] = np.asarray(x)
        return jnp.int32(0)

    jax.random.categorical = capture
    try:
        jengine._select_token(jnp.asarray(logits), jax.random.key(0), (temperature, top_p, top_k))
    finally:
        jax.random.categorical = real
    return seen["x"]


def _logits(rng, ties: bool):
    x = (rng.normal(size=512) * 3).astype(np.float32)
    if ties:  # equal logits at the top and around the top-p cutoff
        x[:6] = x.max()
        order = np.argsort(-x)
        x[order[6:12]] = x[order[6]]
    return x


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.3, 1e-4])
@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("temperature", [1.0, 0.7, 1.5])
def test_filter_matches_select_token(temperature, top_k, top_p, ties):
    """Temperature, top-k, top-p (1e-4 is below the largest probability: at
    least one token, all of its ties) -> the same -inf mask, finite values
    within 1e-6 relative."""
    x = _logits(np.random.default_rng(int(temperature * 10) + top_k + int(top_p * 100)), ties)
    want = jax_filtered(x, temperature, top_p, top_k)
    got = sampling.filter_logits(torch.from_numpy(x), temperature, top_p, top_k).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    live = np.isfinite(want)
    np.testing.assert_allclose(got[live], want[live], rtol=1e-6, atol=0)
    assert live.sum() >= 1


@pytest.mark.parametrize("sampling_cfg", [(1.0, 1.0, 0), (1.3, 0.95, 0), (0.8, 0.9, 20)])
def test_draw_with_jax_noise_equals_categorical(sampling_cfg):
    """Fed ``jax.random.gumbel`` at the engine's keys, the port's draw is
    ``_select_token``'s (``jax.random.categorical``) for both streams."""
    temperature, top_p, top_k = sampling_cfg
    sampler = sampling.Sampler(temperature, top_p, top_k, seed=7, noise_fn=jax_noise)
    rng = np.random.default_rng(3)
    for stream, step in [(sampling.FIRST, 0)] + [(sampling.LOOP, i) for i in range(12)]:
        x = (rng.normal(size=512) * 2).astype(np.float32)
        want = int(jengine._select_token(jnp.asarray(x), jax_key(7, stream, step), sampling_cfg))
        got = sampler.select(torch.from_numpy(x)[None], stream, [step])
        assert int(got[0]) == want, (stream, step)


def test_default_noise_depends_only_on_seed_stream_step():
    a = sampling.gumbel_noise(5, sampling.LOOP, 3, 64, "cpu")
    assert torch.equal(a, sampling.gumbel_noise(5, sampling.LOOP, 3, 64, "cpu"))
    for other in ((6, sampling.LOOP, 3), (5, sampling.FIRST, 3), (5, sampling.LOOP, 4)):
        assert not torch.equal(a, sampling.gumbel_noise(*other, 64, "cpu"))
    rows = sampling.Sampler(seed=5).noise(sampling.LOOP, [3, 9, 3], 64, "cpu")
    assert torch.equal(rows[0], a) and torch.equal(rows[2], a)  # a batch changes no draw


@pytest.mark.parametrize("sample", [
    {"temperature": 1.0},
    {"temperature": 1.3, "top_p": 0.95},
    {"temperature": 1.2, "top_k": 20},
])
def test_sampled_generate_matches_jax_engine(tiny, sample):
    """Sampled ``generate`` (first token and decode loop) on the same
    per-step noise as the JAX engine: the same tokens."""
    cfg, jp, model = tiny
    rd = {"do_sample": True, "seed": 11, **sample, "longvideo_kwargs": CHUNKED}
    ids, patches, grid = video_request(cfg, np.random.default_rng(2), grid_t=4)
    want = JaxEngine(cfg, jp, JaxRetakeConfig.from_dict(rd)).generate(
        ids, patches, grid, max_new_tokens=10)
    eng = Qwen2VLEngine(port_cfg(cfg), model, RetakeConfig.from_dict(rd), device="cpu")
    eng.noise_fn = jax_noise
    got = eng.generate(ids, patches, grid, max_new_tokens=10)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_sampled_generate_is_seeded(tiny):
    """The port's own noise: a seed repeats exactly, temperature 1e-4 gives
    the greedy tokens, top-k with top-p runs (reference
    test_engine.py::test_do_sample_seeded_deterministic)."""
    cfg, _, model = tiny
    ids, patches, grid = video_request(cfg, np.random.default_rng(0))

    def run(**kw):
        eng = Qwen2VLEngine(port_cfg(cfg), model, RetakeConfig(**kw), device="cpu")
        return eng.generate(ids, patches, grid, max_new_tokens=8).tokens

    greedy = run()
    np.testing.assert_array_equal(run(do_sample=True, seed=7), run(do_sample=True, seed=7))
    np.testing.assert_array_equal(run(do_sample=True, temperature=1e-4, seed=3), greedy)
    toks = run(do_sample=True, top_p=0.9, top_k=5, seed=1)
    assert len(toks) >= 1 and ((toks >= 0) & (toks < cfg.vocab_size)).all()


def _requests(cfg, shapes):
    rng = np.random.default_rng(1)
    out = []
    for grid_t, plen in shapes:
        ids, patches, grid = video_request(cfg, rng, grid_t=grid_t, prompt_len=plen)
        out.append(dict(input_ids=ids, pixel_values_videos=patches, video_grid_thw=grid))
    return out


def test_sampled_generate_batch_matches_sequential(tiny):
    """Batched sampled decode draws at the request-own step: the tokens of
    sequential ``generate`` (reference
    test_engine.py::test_generate_batch_sampling_matches_sequential)."""
    cfg, _, model = tiny
    rt = RetakeConfig.from_dict({"do_sample": True, "temperature": 1.2, "top_k": 20, "seed": 5,
                                 "longvideo_kwargs": CHUNKED})
    eng = Qwen2VLEngine(port_cfg(cfg), model, rt, device="cpu")
    reqs = _requests(cfg, ((2, 5), (4, 3), (2, 6)))
    seq = [eng.generate(**r, max_new_tokens=6) for r in reqs]
    batch = eng.generate_batch(reqs, max_new_tokens=6)
    for b, s in zip(batch, seq):
        np.testing.assert_array_equal(b.tokens, s.tokens)


@pytest.mark.parametrize("gap_capacity", [64, 4])
def test_sampled_server_matches_sequential(tiny, gap_capacity):
    """Sampled serving with a staggered third request (non-zero step offset)
    and, at gap capacity 4, compactions that rebase the offsets: the tokens
    of sequential ``generate`` (reference
    test_serve.py::test_continuous_serve_sampling_matches_sequential)."""
    cfg, _, model = tiny
    rt = RetakeConfig.from_dict({"do_sample": True, "temperature": 1.3, "top_p": 0.95,
                                 "seed": 11, "longvideo_kwargs": CHUNKED})
    eng = Qwen2VLEngine(port_cfg(cfg), model, rt, device="cpu")
    reqs = _requests(cfg, ((2, 4), (4, 6), (2, 7)))
    seq = [eng.generate(**r, max_new_tokens=8) for r in reqs]
    server = ContinuousServer(eng, batch_slots=2, segment_steps=2, max_new_tokens=8,
                              gap_capacity=gap_capacity)
    results = server.run(reqs, arrival_times=[0.0, 0.0, 0.01])
    for res, s in zip(results, seq):
        np.testing.assert_array_equal(res.tokens, s.tokens)
    assert (server.stats["compactions"] > 0) == (gap_capacity == 4)
