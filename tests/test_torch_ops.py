"""Port ops against the JAX package on the CPU, fp32, inputs from a numpy
seed: rope, chunk attention and the K1 wrapper, PivotKV and the K2 wrapper,
DPSelect, gap-layout batched decode attention and the K4 wrapper. Where the JAX function reaches a Pallas kernel it runs in
interpret mode, as the JAX package's own tests run it on the CPU; the port's
kernel wrappers take their plain versions on CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from retake_tpu.ops import attention as jattn
from retake_tpu.ops import dpselect as jdp
from retake_tpu.ops import pivotkv as jpkv
from retake_tpu.ops import rope as jrope
from retake_tpu.ops.pallas.decode_gapped import decode_gapped_flash_state as jgapped
from retake_tpu.ops.pallas.flash_prefill import flash_prefill_attention as jflash
from retake_tpu.ops.pallas.pivot_scores import pivot_score_sums as jscores
from retake_tpu_torch.ops import attention as tattn
from retake_tpu_torch.ops import dpselect as tdp
from retake_tpu_torch.ops import pivotkv as tpkv
from retake_tpu_torch.ops import rope as trope
from retake_tpu_torch.ops.cuda import decode_gapped, flash_prefill, pivot_scores
from torch_parity import npy, tt


# ---------------------------------------------------------------- rope


@pytest.mark.parametrize("factor", [None, 4.0])
def test_inv_freq_copies_equal(factor):
    if factor is None:
        np.testing.assert_array_equal(
            trope.default_inv_freq(128, 1e6), jrope.default_inv_freq(128, 1e6)
        )
    else:
        a, sa = trope.yarn_inv_freq(128, 1e6, factor, 32768)
        b, sb = jrope.yarn_inv_freq(128, 1e6, factor, 32768)
        np.testing.assert_array_equal(a, b)
        assert sa == sb


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("yarn", [False, True])
def test_mrope_apply_matches_jax(rng, reverse, yarn):
    """compute_cos_sin + select_mrope + apply_rope (fp32, atol 1e-6)."""
    hd, s = 32, 11
    if yarn:
        inv, scaling = jrope.yarn_inv_freq(hd, 1e6, 4.0, 32768)
    else:
        inv, scaling = jrope.default_inv_freq(hd, 1e6), 1.0
    pos3 = rng.integers(0, 3000, size=(3, s)).astype(np.int32)
    x = rng.normal(size=(4, s, hd)).astype(np.float32)
    sec = (4, 6, 6)

    c3, s3 = jrope.compute_cos_sin(jnp.asarray(inv), jnp.asarray(pos3)[:, None], scaling)
    jc, js = jrope.select_mrope(c3, sec)[0], jrope.select_mrope(s3, sec)[0]
    want = jrope.apply_rope(jnp.asarray(x), jc, js, reverse, scaling)

    tc3, ts3 = trope.compute_cos_sin(tt(inv), tt(pos3)[:, None], scaling)
    tc, ts = trope.select_mrope(tc3, sec)[0], trope.select_mrope(ts3, sec)[0]
    np.testing.assert_allclose(npy(tc), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(npy(ts), np.asarray(js), atol=1e-6)
    got = trope.apply_rope(tt(x), tc, ts, reverse, scaling)
    np.testing.assert_allclose(npy(got), np.asarray(want), atol=1e-6)


def test_rope_reverse_undoes_forward(rng):
    """de-rotation with attention_scaling**2 inverts a scaled rotation."""
    inv, scaling = trope.yarn_inv_freq(16, 1e4, 4.0, 4096)
    pos = torch.from_numpy(rng.integers(0, 500, size=(9,)).astype(np.int32))
    c, s = trope.compute_cos_sin(tt(inv), pos, scaling)
    x = tt(rng.normal(size=(3, 9, 16)).astype(np.float32))
    back = trope.apply_rope(trope.apply_rope(x, c, s), c, s, True, scaling)
    np.testing.assert_allclose(npy(back), npy(x), atol=1e-5)


# ---------------------------------------------------------------- attention / K1

# (H, KV, S, budget, cache_len, valid_len): empty, partial and full caches,
# ragged valid_len (padding query rows attend to themselves)
K1_CASES = [
    (4, 2, 16, 32, 0, 16),
    (4, 2, 16, 32, 13, 11),
    (6, 2, 24, 64, 64, 19),
    (4, 1, 16, 32, 32, 1),
]


@pytest.mark.parametrize("h,kv,s,budget,cache_len,valid_len", K1_CASES)
def test_flash_prefill_wrapper_matches_jax_kernel(rng, h, kv, s, budget, cache_len, valid_len):
    """K1 wrapper (plain version on CPU) and the port's chunk_prefill_attention
    vs the JAX Pallas kernel (interpret) and JAX einsum; fp32, atol 1e-5."""
    d = 16
    q = rng.normal(size=(h, s, d)).astype(np.float32)
    kc, vc = (rng.normal(size=(kv, budget, d)).astype(np.float32) for _ in range(2))
    kn, vn = (rng.normal(size=(kv, s, d)).astype(np.float32) for _ in range(2))
    jargs = [jnp.asarray(a) for a in (q, kc, vc)] + [jnp.int32(cache_len)]
    jargs += [jnp.asarray(kn), jnp.asarray(vn), jnp.int32(valid_len)]
    want_kernel = np.asarray(jflash(*jargs))
    want_einsum = np.asarray(jattn.chunk_prefill_attention(*jargs))
    targs = (tt(q), tt(kc), tt(vc), torch.tensor(cache_len, dtype=torch.int32),
             tt(kn), tt(vn), torch.tensor(valid_len, dtype=torch.int32))
    got = flash_prefill.flash_prefill_attention(*targs)
    np.testing.assert_allclose(npy(got), want_kernel, atol=1e-5)
    np.testing.assert_allclose(npy(tattn.chunk_prefill_attention(*targs)), want_einsum, atol=1e-5)


@pytest.mark.parametrize("cache_len", [0, 7, 20])
def test_decode_appendfree_matches_jax(rng, cache_len):
    h, kv, d, budget = 4, 2, 16, 20
    q = rng.normal(size=(h, 1, d)).astype(np.float32)
    kc, vc = (rng.normal(size=(kv, budget, d)).astype(np.float32) for _ in range(2))
    kn, vn = (rng.normal(size=(kv, 1, d)).astype(np.float32) for _ in range(2))
    want = jattn.decode_attention_appendfree(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(cache_len),
        jnp.asarray(kn), jnp.asarray(vn),
    )
    got = tattn.decode_attention_appendfree(tt(q), tt(kc), tt(vc), cache_len, tt(kn), tt(vn))
    np.testing.assert_allclose(npy(got), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------- PivotKV / K2


@pytest.mark.parametrize("s,valid_len", [(16, 16), (24, 17), (40, 1)])
def test_pivot_scores_wrapper_matches_jax_kernel(rng, s, valid_len):
    """K2 wrapper (plain on CPU) vs the JAX Pallas kernel, then the
    keypatch/padding combine of text._layer vs JAX eviction_scores;
    fp32, atol 1e-5."""
    h, kv, d = 6, 2, 16
    q = rng.normal(size=(h, s, d)).astype(np.float32)
    k = rng.normal(size=(kv, s, d)).astype(np.float32)
    keypatch = rng.random(s) < 0.3
    valid = np.arange(s) < valid_len
    want = np.asarray(jscores(jnp.asarray(q), jnp.asarray(k), jnp.int32(valid_len)))
    sums = pivot_scores.pivot_score_sums(tt(q), tt(k), torch.tensor(valid_len, dtype=torch.int32))
    np.testing.assert_allclose(npy(sums), want, atol=1e-5)

    fused = sums.sum(0) / h
    fused = torch.where(tt(keypatch), 1.0, fused)
    fused = torch.where(tt(valid), fused, tpkv.NEG_INF)
    oracle = np.asarray(jpkv.eviction_scores(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(valid), jnp.asarray(keypatch)
    ))
    np.testing.assert_allclose(npy(fused), oracle, atol=1e-5)
    port = tpkv.eviction_scores(tt(q), tt(k), tt(valid), tt(keypatch))
    np.testing.assert_allclose(npy(port), oracle, atol=1e-5)


@pytest.mark.parametrize("keep_len", [1, 5, 9, 12])
def test_keep_partition_ties_match_jax(keep_len):
    """Ties break toward the lower index, exactly as the JAX stable sort."""
    scores = np.array([0.5, 1.0, 0.5, 0.2, 1.0, 0.5, -1e30, 0.2, 0.5, 1.0, 0.0, 0.5],
                      dtype=np.float32)
    jp, jk = jpkv.keep_partition(jnp.asarray(scores), jnp.int32(keep_len))
    tp, tk = tpkv.keep_partition(tt(scores), torch.tensor(keep_len, dtype=torch.int32))
    np.testing.assert_array_equal(npy(tp), np.asarray(jp))
    np.testing.assert_array_equal(npy(tk), np.asarray(jk))


@pytest.mark.parametrize("keep_len,valid_len", [(5, 12), (12, 12), (1, 7), (7, 9)])
def test_rescale_temporal_positions_matches_jax(rng, keep_len, valid_len):
    s = 12
    t_pos = np.sort(rng.integers(100, 140, size=s)).astype(np.int32)
    kept = np.arange(s) < keep_len
    want = jpkv.rescale_temporal_positions(
        jnp.asarray(t_pos), jnp.asarray(kept), jnp.int32(keep_len), jnp.int32(valid_len)
    )
    got = tpkv.rescale_temporal_positions(
        tt(t_pos), tt(kept), torch.tensor(keep_len, dtype=torch.int32),
        torch.tensor(valid_len, dtype=torch.int32),
    )
    np.testing.assert_array_equal(npy(got), np.asarray(want))


@pytest.mark.parametrize("ratio,q_len", [(0.8665, 2304), (0.5, 7), (0.01, 50), (1.0, 3)])
def test_keep_len_for_chunk_truncates_like_jax(ratio, q_len):
    assert tpkv.keep_len_for_chunk(ratio, q_len) == jpkv.keep_len_for_chunk(ratio, q_len)
    got = tpkv.keep_len_for_chunk(ratio, torch.tensor(q_len, dtype=torch.int32))
    want = jpkv.keep_len_for_chunk(ratio, jnp.int32(q_len))
    assert int(got) == int(want)
    assert tpkv.dynamic_compression_ratio(q_len, 32000) == jpkv.dynamic_compression_ratio(
        q_len, 32000
    )


# ---------------------------------------------------------------- DPSelect


def _bank_with_ties(rng, t=10, n=6, c=8):
    bank = rng.normal(size=(t, n, c)).astype(np.float32)
    bank[4] = bank[3]  # identical adjacent frames: dissimilarity exactly 0
    bank[7] = bank[6]
    bank[8] = bank[6]  # a plateau of equal dissimilarities
    return bank


@pytest.mark.parametrize("sync", [True, False])
@pytest.mark.parametrize("tgt", [3, 6, 10])
def test_dpselect_matches_jax(rng, sync, tgt):
    bank = _bank_with_ties(rng)
    jk, jm = jdp.dpselect(jnp.asarray(bank), tgt, 3, sync)
    tk, tm = tdp.dpselect(tt(bank), tgt, 3, sync)
    np.testing.assert_array_equal(npy(tk), np.asarray(jk))
    np.testing.assert_array_equal(npy(tm), np.asarray(jm))
    np.testing.assert_allclose(
        npy(tdp.gather_keyframes(tt(bank), tk)),
        np.asarray(jdp.gather_keyframes(jnp.asarray(bank), jk)),
    )


def test_local_peaks_tie_breaking_matches_jax():
    dis = np.array([1.0, 0.5, 0.5, 0.2, 0.7, 0.7, 0.7, 0.1, 0.3, 0.3], dtype=np.float32)
    np.testing.assert_array_equal(
        npy(tdp._local_peaks(tt(dis))), np.asarray(jdp._local_peaks(jnp.asarray(dis)))
    )


# ---------------------------------------------------------------- gapped decode / K4

# the cases of tests/test_attention.py: (B, KV, G, D, S, final_len, dec_start
# or None, gap_start, gap_filled). Case 0 has per-slot dec_start holes and a
# free slot (final_len 0); case 1 takes dec_start = gap_start; case 2 is the
# non-power-of-two bucket S = 384.
GAPPED_CASES = [
    (3, 2, 3, 8, 64, [10, 32, 0], [40, 44, 40], 40, 12),
    (3, 2, 3, 8, 64, [10, 32, 0], None, 40, 12),
    (2, 2, 3, 8, 384, [100, 300], [320, 336], 320, 40),
]


def _gapped_inputs(rng, b, kv, g, d, s, lead=()):
    def draw(*shape):
        return (rng.normal(size=shape) * 0.3).astype(np.float32)

    return (draw(b, kv * g, d), draw(*lead, b, kv, s, d), draw(*lead, b, kv, s, d),
            draw(b, kv, d), draw(b, kv, d))


@pytest.mark.parametrize("case", range(len(GAPPED_CASES)))
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_attention_batch_gapped_matches_jax(rng, case, impl):
    """Both port arms (the "pallas" arm reaches the K4 wrapper, which takes
    its plain twin on the CPU) against both JAX arms (the Pallas kernel in
    interpret mode); fp32, atol 2e-5 as the JAX kernel-vs-einsum test."""
    b, kv, g, d, s, fl, ds, gap_start, gap_filled = GAPPED_CASES[case]
    q, kc, vc, kn, vn = _gapped_inputs(rng, b, kv, g, d, s)
    fl = np.asarray(fl, np.int32)
    jds = None if ds is None else jnp.asarray(ds, jnp.int32)
    tds = None if ds is None else torch.tensor(ds, dtype=torch.int32)
    got = tattn.decode_attention_batch_gapped(
        tt(q), tt(kc), tt(vc), tt(fl), gap_start, gap_filled, tt(kn), tt(vn),
        dec_start=tds, impl=impl,
    )
    for jimpl in ("xla", "pallas"):
        want = jattn.decode_attention_batch_gapped(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(fl),
            jnp.int32(gap_start), jnp.int32(gap_filled), jnp.asarray(kn), jnp.asarray(vn),
            dec_start=jds, impl=jimpl,
        )
        np.testing.assert_allclose(npy(got), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_decode_attention_batch_gapped_layer_index_matches_jax(rng, impl):
    """``layer`` indexes a stacked [L, B, KV, S, D] cache: every layer
    against the JAX stacked-mode kernel call (interpret); fp32, atol 2e-5."""
    n_layers, b, kv, g, d, s = 3, 2, 2, 3, 8, 64
    q, kc, vc, kn, vn = _gapped_inputs(rng, b, kv, g, d, s, lead=(n_layers,))
    fl, ds = np.array([10, 32], np.int32), np.array([40, 44], np.int32)
    for li in range(n_layers):
        want = jattn.decode_attention_batch_gapped(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(fl), jnp.int32(40),
            jnp.int32(12), jnp.asarray(kn), jnp.asarray(vn), dec_start=jnp.asarray(ds),
            layer=jnp.int32(li), impl="pallas",
        )
        got = tattn.decode_attention_batch_gapped(
            tt(q), tt(kc), tt(vc), tt(fl), 40, 12, tt(kn), tt(vn), dec_start=tt(ds),
            layer=li, impl=impl,
        )
        np.testing.assert_allclose(npy(got), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("block_k", [None, 128])
def test_decode_gapped_flash_state_plain_matches_jax_kernel(rng, block_k):
    """K4's plain twin against the JAX kernel's unnormalized (acc, m, l)
    (interpret mode; fp32, atol 1e-5 on acc and l, 1e-5 on m). Slot 2 has no
    live column. The TPU kernel only skips blocks that miss both regions, so
    a live-looking block with no live column would leave l > 0 there; its
    dec_start sits at S so that no block is live, and both give the empty
    state m = -1e30, l = 0, acc = 0 (after the merge the two agree in any
    case: the empty state's weight is exp(-1e30 - m2) = 0)."""
    b, kv, g, d, s = 3, 2, 3, 8, 384
    q4 = (rng.normal(size=(b, kv, g, d)) * 0.3).astype(np.float32)
    _, kc, vc, _, _ = _gapped_inputs(rng, b, kv, g, d, s)
    fl, ds, write_end = np.array([100, 300, 0], np.int32), np.array([320, 336, s], np.int32), 360
    jacc, jm, jl = jgapped(jnp.asarray(q4), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(fl),
                           jnp.asarray(ds), jnp.int32(write_end), block_k=block_k)
    n0 = decode_gapped.decode_gapped_flash_state.launches
    acc, m, l = decode_gapped.decode_gapped_flash_state(
        tt(q4), tt(kc), tt(vc), tt(fl), tt(ds), write_end
    )
    assert decode_gapped.decode_gapped_flash_state.launches == n0  # CPU: the plain twin
    np.testing.assert_allclose(npy(acc), np.asarray(jacc), atol=1e-5)
    np.testing.assert_allclose(npy(m), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(npy(l), np.asarray(jl), atol=1e-5, rtol=1e-6)
    assert (npy(m)[2] == decode_gapped.NEG_INF).all()
    assert (npy(l)[2] == 0).all() and (npy(acc)[2] == 0).all()


def test_decode_gapped_plain_empty_slot_merges_to_current_token(rng):
    """A free slot (no live column) merges to exactly the current token's
    value: no 0/0, whatever the buffer holds in the masked columns."""
    b, kv, g, d, s = 2, 2, 3, 8, 64
    q, kc, vc, kn, vn = _gapped_inputs(rng, b, kv, g, d, s)
    vc[1] = 1e30  # slot 1's masked columns hold huge values
    out = tattn.decode_attention_batch_gapped(
        tt(q), tt(kc), tt(vc), torch.tensor([10, 0], dtype=torch.int32), 40, 0, tt(kn), tt(vn),
        impl="pallas",
    )
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(npy(out)[1], np.repeat(vn[1], g, axis=0), atol=1e-6)


def test_decode_attention_batch_gapped_rejects_int8_cache(rng):
    """An int8 cache without its scales, scales beside a float cache, and a
    k scale without a v scale are refused (ValueError), in both arms."""
    q, kc, vc, kn, vn = _gapped_inputs(rng, 1, 2, 3, 8, 16)
    k8, v8 = tt(kc).to(torch.int8), tt(vc).to(torch.int8)
    ones = torch.ones(1, 2, 16)
    fl = torch.tensor([4], dtype=torch.int32)
    for impl in ("xla", "pallas"):
        for kcache, vcache, scales in ((k8, v8, (None, None)), (tt(kc), tt(vc), (ones, ones)),
                                       (k8, v8, (ones, None))):
            with pytest.raises(ValueError):
                tattn.decode_attention_batch_gapped(
                    tt(q), kcache, vcache, fl, 8, 0, tt(kn), tt(vn), *scales, impl=impl,
                )
