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


# K1 at the shapes of the per-question paths (S, budget, cache_len,
# valid_len): a prompt-guided block (a 2304-row chunk with the 49-row
# question after it, full and as a short last chunk of 1999 + 49 rows) and a
# spec-decode verify chunk of draft + 1 = 9 rows over an empty, a ~32k and a
# full cache (S far below the 128-row query block), and the online server's
# prefix-hit text step after a budget recapture (a 6128-row question over
# the 18449 entries of a 256-frame prefix: 48 query blocks)
K1_PATH_CASES = [(2353, 40960, 20000, 2353), (2353, 4096, 3001, 2048), (2353, 4096, 0, 2353),
                 (9, 32768, 32000, 9), (9, 32768, 0, 9), (9, 4096, 4096, 9), (9, 4096, 1001, 5),
                 (6144, 32768, 18449, 6128)]


@pytest.mark.parametrize("s,budget,cache_len,valid_len", K1_PATH_CASES)
@pytest.mark.parametrize("group", [6, 7])
def test_flash_prefill_kernel_matches_plain_at_path_shapes(cuda, s, budget, cache_len, valid_len,
                                                           group):
    # the same tolerance as test_flash_prefill_kernel_matches_plain
    rng = np.random.default_rng(s + cache_len + valid_len + group)
    kv, d = 2, 128
    q = _bf16(rng, (kv * group, s, d), cuda)
    kc, vc = _bf16(rng, (kv, budget, d), cuda), _bf16(rng, (kv, budget, d), cuda)
    kn, vn = _bf16(rng, (kv, s, d), cuda), _bf16(rng, (kv, s, d), cuda)
    cl, vl = _i32(cache_len, cuda), _i32(valid_len, cuda)
    got = flash_prefill.flash_prefill_attention(q, kc, vc, cl, kn, vn, vl)
    again = flash_prefill.flash_prefill_attention(q, kc, vc, cl, kn, vn, vl)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = flash_prefill.flash_prefill_attention_plain(q, kc, vc, cl, kn, vn, vl)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _bf16_tol(want), (err, _bf16_tol(want))


# K2 cases (KV, G, S, valid_len, D): 2B (12/2) and 7B (28/4) heads at the
# main path's S = 2304, full and short; D = 64; G = 1 and G = 16 (two heads
# per CTA of an 8-CTA cluster); S below one 64-row tile (40); S no multiple
# of 64 or 128 (300) with valid_len 257; valid_len = 1; the prompt-guided
# block (2304 + 49 rows, full and as a short last chunk of 1999 + 49)
K2_CASES = [(2, 6, 2304, 2304, 128), (2, 6, 2304, 1999, 128), (4, 7, 2304, 2304, 128),
            (4, 7, 2304, 1999, 128), (2, 6, 300, 257, 64), (2, 6, 2304, 1999, 64),
            (3, 1, 300, 257, 128), (2, 16, 300, 257, 128), (1, 16, 2304, 1999, 64),
            (2, 6, 40, 40, 128), (2, 6, 40, 17, 64), (2, 6, 300, 257, 128),
            (2, 6, 256, 256, 128), (2, 6, 300, 1, 128), (4, 7, 40, 1, 64),
            (2, 6, 2353, 2353, 128), (2, 6, 2353, 2048, 128), (4, 7, 2353, 2048, 128)]


@pytest.mark.parametrize("kv,g,s,valid_len,d", K2_CASES)
def test_pivot_scores_kernel_matches_plain(cuda, kv, g, s, valid_len, d):
    # same bf16 inputs, fp32 math on both sides: only summation order and
    # exp2 vs exp differ -> 1e-4 relative. Every row holds N(0, 1) draws,
    # those past valid_len too, so the whole tiles TMA brings in must be
    # masked (keys) or weigh nothing (query rows)
    rng = np.random.default_rng(kv * g + s + valid_len + d)
    q, k = _bf16(rng, (kv * g, s, d), cuda), _bf16(rng, (kv, s, d), cuda)
    vl = _i32(valid_len, cuda)
    n0 = pivot_scores.pivot_score_sums.launches
    got = pivot_scores.pivot_score_sums(q, k, vl)
    again = pivot_scores.pivot_score_sums(q, k, vl)
    want = pivot_scores.pivot_score_sums_plain(q, k, vl)
    torch.cuda.synchronize()
    assert pivot_scores.pivot_score_sums.launches == n0 + 2
    assert torch.equal(got, again)  # fixed-order reductions: bitwise repeatable
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert (got[:, valid_len:] == 0).all()


@pytest.mark.parametrize("h,kv,d", [(12, 2, 80), (17, 1, 128)])
def test_pivot_scores_raises_on_what_the_kernel_does_not_take(cuda, h, kv, d):
    # D = 80 is no kernel instance; 17 query heads per KV head exceed
    # MAX_GROUP: a ValueError, never the plain twin
    q = torch.zeros((h, 64, d), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((kv, 64, d), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        pivot_scores.pivot_score_sums(q, k, _i32(64, cuda))


# K3 cases (T, N, S, D): 576 = a 448x252 frame (the main path's 16 heads
# of 80, and 4 heads), 100 a small image, 1196 = 644x364, 5120 the
# processor's largest frame; D = 64 beside the model's 80 (1196 at D = 64
# and 2 heads failed in every row past the first key tile when a Q fragment
# was left unwritten); S = 64 with one head, one key tile and no masked key
# (the descriptor check); still images at T = 1 with the model's 16 heads:
# 448x448 (32x32 = 1024), 644x364 (46x26 = 1196) and 36x50 = 1800 (no
# multiple of the 192-row block)
K3_CASES = [(3, 4, 576, 80), (2, 16, 576, 80), (3, 4, 100, 80), (3, 4, 1196, 80),
            (1, 4, 5120, 80), (2, 16, 576, 64), (3, 4, 100, 64), (3, 2, 1196, 64),
            (1, 4, 5120, 64), (1, 1, 64, 80), (1, 1, 64, 64),
            (1, 16, 1024, 80), (1, 16, 1196, 80), (1, 16, 1800, 80)]


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


# K4 cases (B, KV, G, S, final_len, dec_start or None, write_end, D): the
# serving shapes of chip_smoke.py (2B heads, 4 slots, the 43008-column
# bucket, a free slot), a 7B-shaped case, a tail S that is no multiple of the
# 64-column tile, and a slot with no live column next to one whose decode
# region alone is live; then the edges of the one-launch kernel: D = 64,
# G = 1 and 16, S below one 1024-column split, final_len = 0 and = S,
# write_end = dec_start (no decode region), a (slot, head) with exactly one
# live split (written directly, no merge), and none live at all
K4_CASES = [
    (4, 2, 6, 43008, [32002, 18498, 4674, 0], [40960, 40976, 40992, 40960], 41024, 128),
    (4, 2, 6, 43008, [32002, 18498, 4674, 0], None, 40990, 128),
    (4, 4, 7, 8192, [8000, 1, 5000, 7000], [7800, 8100, 8150, 8150], 8190, 128),
    (2, 2, 6, 1000, [999, 0], [900, 1000], 1000, 128),
    (3, 2, 6, 2048, [0, 0, 700], [2048, 1500, 2000], 1530, 128),
    (2, 2, 6, 3000, [2500, 100], [2900, 2950], 2990, 64),
    (3, 2, 1, 2048, [1000, 0, 2048], [1500, 2040, 2048], 2048, 128),
    (2, 2, 16, 4100, [4100, 37], [4100, 4000], 4100, 128),
    (2, 2, 6, 300, [250, 0], [280, 290], 299, 128),
    (2, 2, 6, 43008, [0, 0], [40960, 40970], 41000, 128),
    (2, 2, 6, 2048, [1500, 0], [1600, 1600], 1600, 64),
    (1, 4, 16, 1111, [1111], [1111], 1111, 64),
]


def _check_k4_state(state, plain):
    """A K4 state against its plain twin: the empty state exact, m to 1e-3
    (a max of fp32 dot products summed in another order), the merged
    output (acc / l, bf16) to 2 bf16 steps at its largest value (p rounded
    to bf16 on both sides, the sums in another order)."""
    acc, m, l = state
    pacc, pm, pl = plain
    dead = (pl == 0)
    assert torch.equal(dead, l == 0)
    assert (m[dead] == decode_gapped.NEG_INF).all() and (acc[dead] == 0).all()
    if dead.all():
        return
    assert (m[~dead] - pm[~dead]).abs().max().item() <= 1e-3
    got = (acc / l.clamp(min=1e-37)[..., None]).to(torch.bfloat16)
    want = (pacc / pl.clamp(min=1e-37)[..., None]).to(torch.bfloat16)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _bf16_tol(want), (err, _bf16_tol(want))


def _k4_inputs(case, rng, dev, int8=False):
    b, kv, g, s, fl, ds, write_end, d = case
    q = _bf16(rng, (b, kv, g, d), dev)
    final_len = _i32(fl, dev)
    dec_start = _i32([write_end - 1] * b if ds is None else ds, dev)
    if not int8:
        kc, vc = _bf16(rng, (b, kv, s, d), dev), _bf16(rng, (b, kv, s, d), dev)
        return (q, kc, vc, final_len, dec_start, write_end)
    (kc, ks), (vc, vs) = _int8(rng, (b, kv, s, d), dev), _int8(rng, (b, kv, s, d), dev)
    return (q, kc, vc, final_len, dec_start, write_end, ks, vs)


@pytest.mark.parametrize("case", range(len(K4_CASES)))
def test_decode_gapped_kernel_matches_plain(cuda, case):
    rng = np.random.default_rng(100 + case)
    args = _k4_inputs(K4_CASES[case], rng, cuda)
    q, kc, vc = args[:3]
    # dead columns' cache rows hold NaN: the kernel zeroes their stage rows
    live = decode_gapped.live_columns(kc.shape[2], *args[3:6], cuda)[:, None, :, None]
    kc.masked_fill_(~live, float("nan"))
    vc.masked_fill_(~live, float("nan"))
    n0 = decode_gapped.decode_gapped_flash_state.launches
    state = decode_gapped.decode_gapped_flash_state(*args)
    again = decode_gapped.decode_gapped_flash_state(*args)
    torch.cuda.synchronize()
    assert decode_gapped.decode_gapped_flash_state.launches == n0 + 2
    for x, y in zip(state, again):  # fixed-order sums: bitwise repeatable
        assert torch.equal(x, y)
    kc0, vc0 = kc.masked_fill(~live, 0.0), vc.masked_fill(~live, 0.0)
    _check_k4_state(state, decode_gapped.decode_gapped_flash_state_plain(q, kc0, vc0, *args[3:]))


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


def test_decode_step_batch_flash_takes_k4_and_matches_the_plain_arm(cuda):
    # decode_attn_impl "flash" (the server's and text.decode_step_batch's
    # arm name) runs K4, once per layer, as "pallas" does: one batched step
    # of a 2-layer bf16 model at 2B head geometry over a gap-layout cache,
    # next-token logits against the plain arm within 5% of the largest
    # (chip_smoke.py's E2E_REL_LOGIT_TOL), and bitwise equal to "pallas"
    from retake_tpu_torch.models.qwen2_vl import params, text
    from retake_tpu_torch.models.qwen2_vl.config import Qwen2VisionConfig, Qwen2VLConfig
    from retake_tpu_torch.models.qwen2_vl.model import Qwen2VLModel

    cfg = Qwen2VLConfig(vocab_size=4096, hidden_size=1536, intermediate_size=2048,
                        num_hidden_layers=2, num_attention_heads=12, num_key_value_heads=2,
                        mrope_section=(16, 24, 24),
                        vision=Qwen2VisionConfig(depth=1, embed_dim=160, hidden_size=1536,
                                                 num_heads=2))
    model = Qwen2VLModel(cfg, params.init_params(cfg, seed=0, device=cuda))
    rng = np.random.default_rng(11)
    b, kv, s, d = 3, 2, 10240, 128
    k_all = _bf16(rng, (2, b, kv, s, d), cuda)
    v_all = _bf16(rng, (2, b, kv, s, d), cuda)
    hidden = _bf16(rng, (b, cfg.hidden_size), cuda, 0.05)
    base_t = _i32(rng.integers(100, 4000, size=(2, b)), cuda)
    pos_rest = _i32([4100, 3000, 900], cuda)
    final_len = _i32([8000, 2999, 512], cuda)
    dec_start = _i32([8192, 8200, 8192], cuda)
    out = {}
    for impl in ("flash", "pallas", "xla"):
        n0 = decode_gapped.decode_gapped_flash_state.launches
        h, _, _ = text.decode_step_batch(model, cfg, k_all, v_all, hidden, base_t, pos_rest,
                                         final_len, 8192, 16, dec_start=dec_start,
                                         attn_impl=impl)
        out[impl] = text.final_logits_batch(model, cfg, h)
        n = decode_gapped.decode_gapped_flash_state.launches - n0
        assert n == (0 if impl == "xla" else cfg.num_hidden_layers), (impl, n)
    torch.cuda.synchronize()
    assert torch.equal(out["flash"], out["pallas"])
    a, want = out["flash"], out["xla"]
    assert bool(torch.isfinite(a).all())
    rel = (a - want).abs().max().item() / want.abs().max().item()
    assert rel <= 0.05, rel


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


# int8 K4 cases (B, KV, G, S, final_len, dec_start, write_end, D): the 7B
# serving shape (4 slots, 4 KV heads, G=7, the 43008-column bucket, mixed
# live columns), an all-dead slot, and the edges of K4_CASES; S = 1001 and
# 777 put the scale rows of odd heads at offsets that are no multiple of 16
# bytes (read by plain loads, not bulk copies)
K4_INT8_CASES = [
    (4, 4, 7, 43008, [32002, 18498, 4674, 20000], [40960, 40976, 40992, 40960], 41024, 128),
    (3, 4, 7, 2048, [0, 700, 1500], [2048, 2000, 1800], 2040, 128),
    (2, 2, 6, 3000, [2500, 100], [2900, 2950], 2990, 64),
    (3, 2, 1, 1001, [1001, 0, 500], [1001, 990, 700], 1001, 128),
    (2, 4, 16, 777, [600, 777], [700, 777], 760, 128),
    (2, 2, 7, 300, [250, 0], [280, 290], 299, 64),
    (2, 4, 7, 43008, [0, 0], [40960, 40970], 41000, 128),
    (2, 2, 6, 2048, [1500, 0], [1600, 1600], 1600, 128),
]


@pytest.mark.parametrize("case", range(len(K4_INT8_CASES)))
def test_decode_gapped_int8_kernel_matches_plain(cuda, case):
    # scales commuted on both sides; p * vs rounded to bf16 on both sides,
    # the sums in another order (tolerances in _check_k4_state); bitwise
    # repeat. Dead columns hold random int8 rows and NaN scales, which the
    # kernel brings by bulk copy (16-byte aligned scale rows: S = 43008,
    # 2048, 3000, 300) or by plain loads (odd heads at S = 1001 and 777, and
    # every tail tile) and must mask; the plain twin gets them zeroed (a
    # masked zero-scale column must stay masked)
    rng = np.random.default_rng(200 + case)
    q, kc, vc, fl, ds, we, ks, vs = _k4_inputs(K4_INT8_CASES[case], rng, cuda, int8=True)
    live = decode_gapped.live_columns(kc.shape[2], fl, ds, we, cuda)[:, None, :]
    args = (q, kc, vc, fl, ds, we, ks.masked_fill(~live, float("nan")),
            vs.masked_fill(~live, float("nan")))
    n0 = decode_gapped.decode_gapped_flash_state_int8.launches
    b0 = decode_gapped.decode_gapped_flash_state.launches
    state = decode_gapped.decode_gapped_flash_state(*args)
    again = decode_gapped.decode_gapped_flash_state(*args)
    torch.cuda.synchronize()
    assert decode_gapped.decode_gapped_flash_state_int8.launches == n0 + 2
    assert decode_gapped.decode_gapped_flash_state.launches == b0  # the bf16 mode did not run
    for x, y in zip(state, again):
        assert torch.equal(x, y)
    zeroed = (kc.masked_fill(~live[..., None], 0), vc.masked_fill(~live[..., None], 0),
              fl, ds, we, ks.masked_fill(~live, 0.0), vs.masked_fill(~live, 0.0))
    _check_k4_state(state, decode_gapped.decode_gapped_flash_state_plain(q, *zeroed))


@pytest.mark.parametrize("int8", [False, True])
def test_decode_gapped_repeats_bitwise_over_50_calls(cuda, int8):
    # the last-arriving split resets its counter: 50 calls back to back on
    # one workspace give the same bits
    case = K4_INT8_CASES[0] if int8 else K4_CASES[0]
    args = _k4_inputs(case, np.random.default_rng(300), cuda, int8)
    first = decode_gapped.decode_gapped_flash_state(*args)
    outs = [decode_gapped.decode_gapped_flash_state(*args) for _ in range(50)]
    torch.cuda.synchronize()
    for state in outs:
        for x, y in zip(first, state):
            assert torch.equal(x, y)


@pytest.mark.parametrize("int8", [False, True])
def test_decode_gapped_interleaved_shapes_share_the_workspace(cuda, int8):
    # (4 slots, 2 heads) and (2 slots, 4 heads) at S = 43008 and 42900 have
    # one plan, so they share one workspace and its counters; a third shape
    # has its own. Called interleaved, each gives the bits it gives alone.
    rng = np.random.default_rng(301)
    cases = [(4, 2, 6, 43008, [32002, 18498, 4674, 0], [40960, 40976, 40992, 40960], 41024, 128),
             (2, 4, 6, 42900, [20000, 41000], [41000, 41010], 41030, 128),
             (3, 2, 6, 1000, [999, 0, 10], [900, 1000, 500], 1000, 128)]
    plans = [decode_gapped.launch_plan(*c[:4], c[7], int8) for c in cases]
    assert plans[0] == plans[1]
    inputs = [_k4_inputs(c, rng, cuda, int8) for c in cases]
    alone = [decode_gapped.decode_gapped_flash_state(*a) for a in inputs]
    mixed = [decode_gapped.decode_gapped_flash_state(*inputs[i % 3]) for i in range(12)]
    torch.cuda.synchronize()
    for i, state in enumerate(mixed):
        for x, y in zip(alone[i % 3], state):
            assert torch.equal(x, y)
    for a, state in zip(inputs, alone):
        _check_k4_state(state, decode_gapped.decode_gapped_flash_state_plain(*a))


@pytest.mark.parametrize("int8", [False, True])
def test_decode_gapped_launch_captures_in_a_cuda_graph(cuda, int8):
    # one launch, no allocation but its output: after one eager warm-up
    # call (which makes the workspace), a call captures in a CUDA graph and
    # its replay gives the eager bits
    case = K4_INT8_CASES[0] if int8 else K4_CASES[0]
    args = _k4_inputs(case, np.random.default_rng(302), cuda, int8)
    eager = decode_gapped.decode_gapped_flash_state(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = decode_gapped.decode_gapped_flash_state(*args)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    for x, y in zip(eager, captured):
        assert torch.equal(x, y)


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
