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

from retake_tpu_torch.ops.cuda import flash_prefill, pivot_scores, vit_attention

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


@pytest.mark.parametrize(
    "s,cache_len,valid_len", [(256, 0, 250), (256, 1000, 256), (256, 4096, 199), (200, 37, 150)]
)
@pytest.mark.parametrize("group", [6, 7])
def test_flash_prefill_kernel_matches_plain(cuda, s, cache_len, valid_len, group):
    # bf16 output of an average of N(0,1) values: both paths round p to bf16
    # (the kernel before, the plain version after normalizing) -> 2 bf16
    # steps at the largest output
    rng = np.random.default_rng(cache_len + valid_len + group)
    kv, d, budget = 2, 128, 4096
    q = _bf16(rng, (kv * group, s, d), cuda)
    kc, vc = _bf16(rng, (kv, budget, d), cuda), _bf16(rng, (kv, budget, d), cuda)
    kn, vn = _bf16(rng, (kv, s, d), cuda), _bf16(rng, (kv, s, d), cuda)
    cl, vl = _i32(cache_len, cuda), _i32(valid_len, cuda)
    n0 = flash_prefill.flash_prefill_attention.launches
    got = flash_prefill.flash_prefill_attention(q, kc, vc, cl, kn, vn, vl)
    torch.cuda.synchronize()
    assert flash_prefill.flash_prefill_attention.launches == n0 + 1
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


# 576: a 448x252 frame; 1196: 644x364; 5120: the processor's largest frame
@pytest.mark.parametrize("s", [576, 100, 1196, 5120])
def test_vit_attention_kernel_matches_plain(cuda, s):
    # bf16 output; p rounded to bf16 on both sides after normalizing -> 2
    # bf16 steps at the largest output
    rng = np.random.default_rng(s)
    t, n, d = 3, 4, 80
    qkv = _bf16(rng, (t, s, n, 3, d), cuda)
    ang = rng.uniform(0, 6.3, size=(s, d)).astype(np.float32)
    cos = torch.from_numpy(np.cos(ang)).to(cuda)
    sin = torch.from_numpy(np.sin(ang)).to(cuda)
    got = vit_attention.vit_attention_qkv(qkv, cos, sin)
    want = vit_attention.vit_attention_qkv_plain(qkv, cos, sin)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _bf16_tol(want), (err, _bf16_tol(want))


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
