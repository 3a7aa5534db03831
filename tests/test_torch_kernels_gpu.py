"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA device (marker ``gpu``) and skips without one.
Run on the H100 with:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q --noconftest

(``--noconftest``: the suite's conftest configures JAX, which this file does
not use). Inputs are bf16 N(0, 1) draws from a numpy seed; tolerances are
stated per test.
"""

import numpy as np
import pytest
import torch

from retake_tpu_torch.ops import attention
from retake_tpu_torch.ops.cuda import decode_gapped, flash_prefill, pivot_scores, vit_attention
from retake_tpu_torch.ops.quantization import int8_linear, quantize_kv_block, quantize_weight

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16(rng, shape, dev, scale=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(dev, torch.bfloat16)


def _i32(x, dev):
    return torch.tensor(x, dtype=torch.int32, device=dev)


def _bf16_tol(want, steps=2):
    """``steps`` steps of bf16 (8 significant bits) at max|want|: one for
    the output's rounding, one for p rounded at a different point."""
    top = want.float().abs().max().item()
    return steps * 2.0 ** (np.floor(np.log2(top)) - 7)


# K1 cases (S, cache_len, valid_len) over a 4096-row cache: S no multiple of
# the 128-row query block (200, 2305) and the main path's 2304; cache_len no
# multiple of the 64-key tile (37, 3001), equal to the budget, and 0 with
# valid_len < S
K1_CASES = [(256, 0, 250), (256, 1000, 256), (256, 4096, 199), (200, 37, 150),
            (2304, 3001, 2304), (2305, 0, 1999)]


@pytest.mark.parametrize("s,cache_len,valid_len", K1_CASES)
@pytest.mark.parametrize("group", [6, 7])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_prefill_kernel_matches_plain(cuda, s, cache_len, valid_len, group, d):
    # bf16 output of an average of N(0,1) values: both paths round p to bf16
    # (the kernel before, the plain version after normalizing) -> 2 bf16
    # steps at the largest output; no split over keys -> bitwise repeat
    rng = np.random.default_rng(cache_len + valid_len + group + d)
    kv, budget = 2, 4096
    q = _bf16(rng, (kv * group, s, d), cuda)
    kc, vc = _bf16(rng, (kv, budget, d), cuda), _bf16(rng, (kv, budget, d), cuda)
    kn, vn = _bf16(rng, (kv, s, d), cuda), _bf16(rng, (kv, s, d), cuda)
    cl, vl = _i32(cache_len, cuda), _i32(valid_len, cuda)
    n0 = flash_prefill.flash_prefill_attention.launches
    got = flash_prefill.flash_prefill_attention(q, kc, vc, cl, kn, vn, vl)
    again = flash_prefill.flash_prefill_attention(q, kc, vc, cl, kn, vn, vl)
    torch.cuda.synchronize()
    assert flash_prefill.flash_prefill_attention.launches == n0 + 2
    assert torch.equal(got, again)
    want = flash_prefill.flash_prefill_attention_plain(q, kc, vc, cl, kn, vn, vl)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _bf16_tol(want), (err, _bf16_tol(want))


@pytest.mark.parametrize("s,valid_len", [(256, 256), (300, 257)])
def test_pivot_scores_kernel_matches_plain(cuda, s, valid_len):
    # same bf16 inputs, fp32 math on both sides: only summation order and
    # exp2 vs exp differ -> 1e-4 relative
    rng = np.random.default_rng(s + valid_len)
    kv, g, d = 2, 6, 128
    q, k = _bf16(rng, (kv * g, s, d), cuda), _bf16(rng, (kv, s, d), cuda)
    vl = _i32(valid_len, cuda)
    got = pivot_scores.pivot_score_sums(q, k, vl)
    again = pivot_scores.pivot_score_sums(q, k, vl)
    want = pivot_scores.pivot_score_sums_plain(q, k, vl)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # fixed-order reductions: bitwise repeatable
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# K3 cases (T, N, S, D): 576 = a 448x252 frame (the main path's 16 heads
# of 80, and 4 heads), 100 a small image, 1196 = 644x364, 5120 the
# processor's largest frame; D = 64 beside the model's 80 (1196 at D = 64
# and 2 heads failed in every row past the first key tile when a Q fragment
# was left unwritten); S = 64 with one head, one key tile and no masked key
# (the descriptor check)
K3_CASES = [(3, 4, 576, 80), (2, 16, 576, 80), (3, 4, 100, 80), (3, 4, 1196, 80),
            (1, 4, 5120, 80), (2, 16, 576, 64), (3, 4, 100, 64), (3, 2, 1196, 64),
            (1, 4, 5120, 64), (1, 1, 64, 80), (1, 1, 64, 64)]


@pytest.mark.parametrize("t,n,s,d", K3_CASES)
def test_vit_attention_kernel_matches_plain(cuda, t, n, s, d):
    # bf16 output: the kernel rounds p to bf16 before normalizing (online
    # softmax, out = acc / l), the plain twin after normalizing -> 2 bf16
    # steps at the largest output; no split over keys -> bitwise repeat
    rng = np.random.default_rng(s + n + d)
    qkv = _bf16(rng, (t, s, n, 3, d), cuda)
    ang = rng.uniform(0, 6.3, size=(s, d)).astype(np.float32)
    cos = torch.from_numpy(np.cos(ang)).to(cuda)
    sin = torch.from_numpy(np.sin(ang)).to(cuda)
    n0 = vit_attention.vit_attention_qkv.launches
    got = vit_attention.vit_attention_qkv(qkv, cos, sin)
    again = vit_attention.vit_attention_qkv(qkv, cos, sin)
    torch.cuda.synchronize()
    assert vit_attention.vit_attention_qkv.launches == n0 + 2
    assert torch.equal(got, again)
    want = vit_attention.vit_attention_qkv_plain(qkv, cos, sin)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _bf16_tol(want), (err, _bf16_tol(want))


# K4 cases (B, KV, G, S, final_len, dec_start or None, write_end): the serving
# shapes of chip_smoke.py (2B heads, 4 slots, the 43008-column bucket, a free
# slot), a 7B-shaped case, a tail S that is no multiple of the 64-column
# tile, and a slot with no live column next to one whose decode region alone
# is live
K4_CASES = [
    (4, 2, 6, 43008, [32002, 18498, 4674, 0], [40960, 40976, 40992, 40960], 41024),
    (4, 2, 6, 43008, [32002, 18498, 4674, 0], None, 40990),
    (4, 4, 7, 8192, [8000, 1, 5000, 7000], [7800, 8100, 8150, 8150], 8190),
    (2, 2, 6, 1000, [999, 0], [900, 1000], 1000),
    (3, 2, 6, 2048, [0, 0, 700], [2048, 1500, 2000], 1530),
]


@pytest.mark.parametrize("case", range(len(K4_CASES)))
def test_decode_gapped_kernel_matches_plain(cuda, case):
    # after the merge, bf16 output of an average of N(0, 1) values: p is
    # rounded to bf16 on both sides, the sums run in another order -> 2 bf16
    # steps at the largest output; m is a max of fp32 dot products -> 1e-3
    b, kv, g, s, fl, ds, write_end = K4_CASES[case]
    rng = np.random.default_rng(100 + case)
    d = 128
    q = _bf16(rng, (b, kv, g, d), cuda)
    kc, vc = _bf16(rng, (b, kv, s, d), cuda), _bf16(rng, (b, kv, s, d), cuda)
    final_len = _i32(fl, cuda)
    dec_start = _i32([write_end - 1] * b if ds is None else ds, cuda)
    n0 = decode_gapped.decode_gapped_flash_state.launches
    acc, m, l = decode_gapped.decode_gapped_flash_state(q, kc, vc, final_len, dec_start, write_end)
    again = decode_gapped.decode_gapped_flash_state(q, kc, vc, final_len, dec_start, write_end)
    torch.cuda.synchronize()
    assert decode_gapped.decode_gapped_flash_state.launches == n0 + 2
    for x, y in zip((acc, m, l), again):  # fixed-order sums: bitwise repeatable
        assert torch.equal(x, y)
    pacc, pm, pl = decode_gapped.decode_gapped_flash_state_plain(
        q, kc, vc, final_len, dec_start, write_end
    )
    dead = (pl == 0)
    assert torch.equal(dead, l == 0)
    assert (m[dead] == decode_gapped.NEG_INF).all() and (acc[dead] == 0).all()
    assert (m - pm).abs().max().item() <= 1e-3
    got = (acc / l.clamp(min=1e-37)[..., None]).to(torch.bfloat16)
    want = (pacc / pl.clamp(min=1e-37)[..., None]).to(torch.bfloat16)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _bf16_tol(want), (err, _bf16_tol(want))


def test_decode_attention_batch_gapped_kernel_arm_matches_plain_arm(cuda):
    # the merged output of both arms at the serving shapes (bf16 output, 2
    # bf16 steps); a free slot returns exactly the current token's value
    rng = np.random.default_rng(7)
    b, kv, g, s, d = 4, 2, 6, 43008, 128
    q = _bf16(rng, (b, kv * g, d), cuda)
    kc, vc = _bf16(rng, (b, kv, s, d), cuda), _bf16(rng, (b, kv, s, d), cuda)
    kn, vn = _bf16(rng, (b, kv, d), cuda), _bf16(rng, (b, kv, d), cuda)
    fl, ds = _i32([32002, 18498, 4674, 0], cuda), _i32([40960, 40976, 40992, 41024], cuda)
    args = (q, kc, vc, fl, 40960, 64, kn, vn)
    got = attention.decode_attention_batch_gapped(*args, dec_start=ds, impl="pallas")
    want = attention.decode_attention_batch_gapped(*args, dec_start=ds, impl="xla")
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _bf16_tol(want), (err, _bf16_tol(want))
    assert torch.equal(got[3], vn[3].repeat_interleave(g, dim=0))


def _int8(rng, shape, dev):
    """int8 K/V and per-key scales of N(0, 1) draws (quantize_kv_block)."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    return quantize_kv_block(x.to(torch.bfloat16))


# the same edges in int8 mode (S, cache_len, valid_len), 4096-row cache
K1_INT8_CASES = [(256, 0, 250), (256, 1000, 256), (200, 3001, 150), (2304, 4096, 2304),
                 (2305, 37, 1999)]


@pytest.mark.parametrize("s,cache_len,valid_len", K1_INT8_CASES)
@pytest.mark.parametrize("group", [6, 7])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_prefill_int8_kernel_matches_plain(cuda, s, cache_len, valid_len, group, d):
    # the int8 mode: both sides dequantize each element to bf16(f32(x) * s)
    # and then differ as in bf16 mode (p rounded before vs after the
    # normalization) -> 2 bf16 steps at the largest output; bitwise repeat
    rng = np.random.default_rng(cache_len + valid_len + group + d + 1)
    kv, budget = 2 if group == 6 else 4, 4096
    q = _bf16(rng, (kv * group, s, d), cuda)
    (kc, kcs), (vc, vcs) = _int8(rng, (kv, budget, d), cuda), _int8(rng, (kv, budget, d), cuda)
    (kn, kns), (vn, vns) = _int8(rng, (kv, s, d), cuda), _int8(rng, (kv, s, d), cuda)
    cl, vl = _i32(cache_len, cuda), _i32(valid_len, cuda)
    args = (q, kc, vc, cl, kn, vn, vl, kcs, vcs, (kns, vns))
    n0 = flash_prefill.flash_prefill_attention_int8.launches
    b0 = flash_prefill.flash_prefill_attention.launches
    got = flash_prefill.flash_prefill_attention(*args)
    again = flash_prefill.flash_prefill_attention(*args)
    torch.cuda.synchronize()
    assert flash_prefill.flash_prefill_attention_int8.launches == n0 + 2
    assert flash_prefill.flash_prefill_attention.launches == b0  # the bf16 mode did not run
    assert torch.equal(got, again)
    want = flash_prefill.flash_prefill_attention_plain(*args)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _bf16_tol(want), (err, _bf16_tol(want))


# int8 K4 cases: the 7B serving shape (4 slots, 4 KV heads, G=7, the
# 43008-column bucket, mixed live columns), and an all-dead slot
K4_INT8_CASES = [
    (4, 4, 7, 43008, [32002, 18498, 4674, 20000], [40960, 40976, 40992, 40960], 41024),
    (3, 4, 7, 2048, [0, 700, 1500], [2048, 2000, 1800], 2040),
]


@pytest.mark.parametrize("case", range(len(K4_INT8_CASES)))
def test_decode_gapped_int8_kernel_matches_plain(cuda, case):
    # scales commuted on both sides; p * vs rounded to bf16 on both sides,
    # the sums in another order -> after the merge 2 bf16 steps at the
    # largest output; m to 1e-3; masked columns of the first case hold zero
    # scales (a masked zero-scale column must stay masked); bitwise repeat
    b, kv, g, s, fl, ds, write_end = K4_INT8_CASES[case]
    rng = np.random.default_rng(200 + case)
    d = 128
    q = _bf16(rng, (b, kv, g, d), cuda)
    (kc, ks), (vc, vs) = _int8(rng, (b, kv, s, d), cuda), _int8(rng, (b, kv, s, d), cuda)
    final_len, dec_start = _i32(fl, cuda), _i32(ds, cuda)
    live = decode_gapped.live_columns(s, final_len, dec_start, write_end, cuda)[:, None, :]
    ks, vs = torch.where(live, ks, 0.0), torch.where(live, vs, 0.0)
    args = (q, kc, vc, final_len, dec_start, write_end, ks, vs)
    n0 = decode_gapped.decode_gapped_flash_state_int8.launches
    acc, m, l = decode_gapped.decode_gapped_flash_state(*args)
    again = decode_gapped.decode_gapped_flash_state(*args)
    torch.cuda.synchronize()
    assert decode_gapped.decode_gapped_flash_state_int8.launches == n0 + 2
    for x, y in zip((acc, m, l), again):
        assert torch.equal(x, y)
    pacc, pm, pl = decode_gapped.decode_gapped_flash_state_plain(*args)
    dead = (pl == 0)
    assert torch.equal(dead, l == 0)
    assert (m[dead] == decode_gapped.NEG_INF).all() and (acc[dead] == 0).all()
    assert (m - pm).abs().max().item() <= 1e-3
    got = (acc / l.clamp(min=1e-37)[..., None]).to(torch.bfloat16)
    want = (pacc / pl.clamp(min=1e-37)[..., None]).to(torch.bfloat16)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _bf16_tol(want), (err, _bf16_tol(want))


@pytest.mark.parametrize("rows", [4, 16, 17, 300])
def test_w8a8_linear_on_the_card_matches_the_cpu(cuda, rows):
    # torch._int_mm on CUDA refuses <= 16 rows, and at k=64 any row count
    # that is no multiple of 32: int8_matmul_prequant pads with zero rows.
    # The int32 sums are exact on both devices, the quantizers divide the
    # same way and the fp32 dequant is the same two products -> 1e-6 relative
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.standard_normal((2, rows, 64)).astype(np.float32))
    wq = quantize_weight(torch.from_numpy(rng.standard_normal((64, 40)).astype(np.float32)))
    want = int8_linear(x, wq["w"], wq["scale"])
    got = int8_linear(x.to(cuda), wq["w"].to(cuda), wq["scale"].to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6 * want.abs().max().item())


def test_wrappers_raise_on_bad_input(cuda):
    q = torch.zeros((12, 64, 128), dtype=torch.float32, device=cuda)
    kc = torch.zeros((2, 128, 128), dtype=torch.float32, device=cuda)
    kn = torch.zeros((2, 64, 128), dtype=torch.float32, device=cuda)
    one = _i32(1, cuda)
    with pytest.raises(TypeError):  # fp32 is not a kernel dtype: no fallback
        flash_prefill.flash_prefill_attention(q, kc, kc, one, kn, kn, one)
    with pytest.raises(TypeError):  # lengths must live on the device
        flash_prefill.flash_prefill_attention(
            q.bfloat16(), kc.bfloat16(), kc.bfloat16(), 1,
            kn.bfloat16(), kn.bfloat16(), one,
        )
    q4 = torch.zeros((1, 2, 6, 128), dtype=torch.bfloat16, device=cuda)
    kc4 = torch.zeros((1, 2, 64, 128), dtype=torch.bfloat16, device=cuda)
    fl = _i32([8], cuda)
    with pytest.raises(TypeError):  # write_end is a host int on CUDA
        decode_gapped.decode_gapped_flash_state(q4, kc4, kc4, fl, fl, _i32(8, cuda))
    with pytest.raises(ValueError):  # 17 query rows per KV head exceed the mma tile
        decode_gapped.decode_gapped_flash_state(
            torch.zeros((1, 2, 17, 128), dtype=torch.bfloat16, device=cuda), kc4, kc4, fl, fl, 8
        )
