"""The launch plans of K1-K4
(``ops/cuda/{flash_prefill,pivot_scores,vit_attention,decode_gapped}.launch_plan``),
checked on the CPU.

The kernels cannot run here, but the plans they are launched with are plain
Python: the grid must cover every (head, query row) (K3: every slice, head
and patch row), the shared memory must fit one H100 block, the TMA ring
must have stages to overlap, and the query block must be whole 64-row
warpgroups. K4's splits must cover every cache column once, two CTAs must
fit one SM, and its workspace must hold one partial state per split.
K2's grids must cover every (query head, row), every (query head, key) and
every (KV head, key) once, and its workspace every row statistic and
column sum that its launches write.
"""

import numpy as np
import pytest

from retake_tpu_torch.ops.cuda import decode_gapped, flash_prefill, pivot_scores, vit_attention

# (query heads, KV heads): Qwen2-VL-2B and -7B
HEADS = [(12, 2), (28, 4)]


def _covered(plan, heads, s):
    """Every (head, row) each CTA of the grid owns, as a [heads, s] count.
    The kernel's CTA (x, y) takes head x and the rows from (gy - 1 - y) * bq
    (the longest blocks first)."""
    seen = np.zeros((heads, s), dtype=np.int64)
    gx, gy = plan["grid"]
    for x in range(gx):
        for y in range(gy):
            lo = (gy - 1 - y) * plan["bq"]
            seen[x, lo:min(lo + plan["bq"], s)] += 1
    return seen


@pytest.mark.parametrize("heads,kv", HEADS)
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("int8", [False, True])
def test_launch_plan_covers_every_row_and_fits_the_block(heads, kv, d, int8):
    for s in (1, 200, 2304, 2305):
        plan = flash_prefill.launch_plan(heads, kv, s, d, int8)
        assert (_covered(plan, heads, s) == 1).all(), s
        assert plan["grid"][0] == heads  # the head index varies fastest
    assert plan["smem_bytes"] <= 232_448
    assert plan["stages"] >= 2
    assert plan["bq"] % 64 == 0 and plan["bk"] == 64
    # consumer warpgroups + producer warpgroups (two in int8 mode)
    assert plan["block"] == 128 * (plan["bq"] // 64) + 128 * (2 if int8 else 1)


def test_launch_plan_pins_the_kernels_plan():
    # BQ 128 (two consumer warpgroups), 4 ring stages; shared memory: 1024
    # alignment slack + Q block + K|V tiles + mbarriers. bf16: 4 operand
    # tiles with full / empty barriers and the Q barrier; int8: 4 int8
    # tiles (one barrier each) and three bf16 operand tiles
    bf16 = flash_prefill.launch_plan(12, 2, 2304, 128, False)
    assert bf16 == dict(grid=(12, 18), block=384, bq=128, bk=64, stages=4,
                        smem_bytes=1024 + 32768 + 4 * 32768 + 8 * 9)
    int8 = flash_prefill.launch_plan(28, 4, 2304, 128, True)
    assert int8 == dict(grid=(28, 18), block=512, bq=128, bk=64, stages=4,
                        smem_bytes=1024 + 32768 + 4 * 16384 + 3 * 32768 + 8 * (7 + 4))


@pytest.mark.parametrize("kw", [dict(d=96), dict(heads=13)])
def test_launch_plan_refuses_what_the_kernel_does_not_take(kw):
    args = dict(heads=12, num_kv=2, s=2304, d=128, int8=False)
    args.update(kw)
    with pytest.raises(ValueError):
        flash_prefill.launch_plan(**args)


def _covered_k3(plan, t, s, n):
    """Every (slice, head, row) each CTA owns, as a [t, n, s] count. The
    kernel's CTA (x, y, z) takes query rows x * bq .. + bq of head y, slice z."""
    seen = np.zeros((t, n, s), dtype=np.int64)
    gx, gy, gz = plan["grid"]
    for x in range(gx):
        seen[:gz, :gy, x * plan["bq"]:min((x + 1) * plan["bq"], s)] += 1
    return seen


# 1: one patch; 100: a small image; 576: a 448x252 frame; 1196: 644x364;
# 5120: the processor's largest frame
@pytest.mark.parametrize("s", [1, 100, 576, 1196, 5120])
@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("d", [64, 80])
def test_vit_launch_plan_covers_every_row_once(s, n, d):
    plan = vit_attention.launch_plan(3, s, n, d)
    assert (_covered_k3(plan, 3, s, n) == 1).all()
    assert plan["grid"][1:] == (n, 3)  # the query block is the fastest index


@pytest.mark.parametrize("d", [64, 80])
def test_vit_launch_plan_fits_the_block(d):
    plan = vit_attention.launch_plan(128, 576, 16, d)
    assert plan["smem_bytes"] <= 232_448
    assert plan["stages"] >= 2
    assert plan["bq"] % 64 == 0 and plan["bk"] == 64
    # consumer warpgroups (64 query rows each) + one producer warpgroup
    assert plan["block"] == 128 * (plan["bq"] // 64 + 1)


def test_vit_launch_plan_pins_the_kernels_plan():
    # the main path: T = 128 slices, 32x18 patches, 16 heads of 80. BQ 192
    # (three consumer warpgroups), 2 raw and 3 operand stages; shared memory:
    # 1024 alignment slack + 2 raw tiles (64 rows of bf16 k, f32 cos, f32
    # sin) + 3 operand tiles (K: two 64 x 128 B boxes, V: five 64 x 32 B
    # boxes) + 8 mbarriers
    plan = vit_attention.launch_plan(128, 576, 16, 80)
    assert plan == dict(grid=(3, 16, 128), block=512, bq=192, bk=64, stages=3,
                        smem_bytes=1024 + 2 * (10240 + 2 * 20480) + 3 * (16384 + 10240) + 8 * 8)


@pytest.mark.parametrize("kw", [dict(d=96), dict(d=128), dict(s=0), dict(n=70000)])
def test_vit_launch_plan_refuses_what_the_kernel_does_not_take(kw):
    args = dict(t=128, s=576, n=16, d=80)
    args.update(kw)
    with pytest.raises(ValueError):
        vit_attention.launch_plan(**args)


# one H100 SM: 228 KB of shared memory, of which a CTA may take 227 KB and
# the system reserves 1 KB per CTA
SM_SHARED = 233_472
CTA_RESERVED = 1024

# K4 shapes (B, KV, G, S, D): the 2B and 7B serving cases (4 slots, the
# 43008-column bucket), S below one split, S no multiple of the tile, G = 1
# and 16, D = 64
K4_SHAPES = [(4, 2, 6, 43008, 128), (4, 4, 7, 43008, 128), (2, 2, 6, 1000, 128),
             (3, 4, 7, 2048, 128), (1, 1, 1, 1, 64), (2, 3, 16, 777, 64), (1, 2, 16, 513, 128)]


@pytest.mark.parametrize("shape", K4_SHAPES)
@pytest.mark.parametrize("int8", [False, True])
def test_decode_gapped_plan_covers_every_column_once(shape, int8):
    b, kv, g, s, d = shape
    plan = decode_gapped.launch_plan(b, kv, g, s, d, int8)
    n_split, n_bk = plan["grid"]
    assert n_bk == b * kv
    seen = np.zeros(s, dtype=np.int64)
    for x in range(n_split):  # CTA x takes columns x * split .. + split
        seen[x * plan["split"]:min((x + 1) * plan["split"], s)] += 1
    assert (seen == 1).all()
    assert (n_split - 1) * plan["split"] < s  # no split starts past the end
    assert plan["split"] % plan["bk"] == 0 and plan["bk"] == 64


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_gapped_plan_fits_two_ctas_per_sm(d, int8):
    plan = decode_gapped.launch_plan(4, 4, 16, 43008, d, int8)
    assert plan["smem_bytes"] <= 232_448
    assert 2 * (plan["smem_bytes"] + CTA_RESERVED) <= SM_SHARED
    assert plan["stages"] >= 2 and plan["consumer_warps"] >= 1
    assert plan["block"] == 32 * (plan["consumer_warps"] + 1)  # + the producer warp


@pytest.mark.parametrize("shape", K4_SHAPES)
def test_decode_gapped_plan_workspace_matches_the_grid(shape):
    b, kv, g, s, d = shape
    plan = decode_gapped.launch_plan(b, kv, g, s, d, False)
    n_split, n_bk = plan["grid"]
    # a partial acc [G, D] and (m, l) [2, G] per split and per group of 8
    # splits of every (slot, head)
    n_groups = -(-n_split // 8)
    assert plan["workspace_floats"] == n_bk * (n_split + n_groups) * (g * d + 2 * g)
    # one arrival counter per (slot, head) for its groups, one per group
    assert plan["counters"] == n_bk * (1 + n_groups)


def test_decode_gapped_plan_pins_the_serving_plans():
    # 1024-column splits, 3 ring stages, 4 consumer warps + 1 producer; a
    # stage is 64 K rows and 64 V rows (int8: and the two f32 scale rows,
    # the stage rounded up to 1024 bytes), after 1024 bytes of alignment
    # slack; then 8 mbarriers (the ring's and the merge's two)
    bf16 = decode_gapped.launch_plan(4, 2, 6, 43008, 128, False)
    assert bf16 == dict(grid=(42, 8), block=160, bk=64, split=1024, stages=3, consumer_warps=4,
                        smem_bytes=1024 + 3 * 2 * 64 * 256 + 64,
                        workspace_floats=8 * (42 + 6) * 6 * 130, counters=8 * 7)
    int8 = decode_gapped.launch_plan(4, 4, 7, 43008, 128, True)
    assert int8 == dict(grid=(42, 16), block=160, bk=64, split=1024, stages=3, consumer_warps=4,
                        smem_bytes=1024 + 3 * (2 * 64 * 128 + 1024) + 64,
                        workspace_floats=16 * (42 + 6) * 7 * 130, counters=16 * 7)


@pytest.mark.parametrize("kw", [dict(g=17), dict(g=0), dict(d=96), dict(d=80), dict(s=0),
                                dict(b=0), dict(s=128 * 1024 + 1)])
def test_decode_gapped_plan_refuses_what_the_kernel_does_not_take(kw):
    args = dict(b=4, kv=2, g=6, s=43008, d=128, int8=False)
    args.update(kw)
    with pytest.raises(ValueError):
        decode_gapped.launch_plan(**args)


# K2 shapes: Qwen2-VL-2B and -7B heads; S below one tile, no multiple of
# the 128-row block, the main path's 2304 and twice that
K2_S = [40, 300, 2304, 4608]


@pytest.mark.parametrize("heads,kv", HEADS)
@pytest.mark.parametrize("s", K2_S)
def test_pivot_plan_covers_every_row_and_column_once(heads, kv, s):
    plan = pivot_scores.launch_plan(heads, kv, s, 128)
    bq, g = plan["bq"], heads // kv
    # launch 1: CTA (x, y) takes query head x, rows y * bq .. + bq
    rows = np.zeros((heads, s), dtype=np.int64)
    gx, gy = plan["rows"]["grid"]
    assert gx == heads  # the head index varies fastest
    for y in range(gy):
        rows[:, y * bq:min((y + 1) * bq, s)] += 1
    assert (rows == 1).all()
    # launch 2: CTA (x, y, z) takes query head z * g + x against keys
    # y * bq .. + bq of KV head z: every (query head, key) once
    nx, ny, nz = plan["cols"]["grid"]
    assert (nx, nz) == (g, kv)
    pairs = np.zeros((heads, s), dtype=np.int64)
    for z in range(nz):
        for x in range(nx):
            for y in range(ny):
                pairs[z * g + x, y * bq:min((y + 1) * bq, s)] += 1
    assert (pairs == 1).all()
    assert (ny - 1) * bq < s  # no key block starts past the end
    # launch 3: thread i of CTA (x, z) writes key x * block + i of KV head z
    mx, mz = plan["merge"]["grid"]
    keys = np.zeros((kv, s), dtype=np.int64)
    for x in range(mx):
        keys[:mz, x * plan["merge"]["block"]:min((x + 1) * plan["merge"]["block"], s)] += 1
    assert mz == kv and (keys == 1).all()


@pytest.mark.parametrize("heads,kv", HEADS)
@pytest.mark.parametrize("s", K2_S)
@pytest.mark.parametrize("d", [64, 128])
def test_pivot_plan_fits_two_ctas_per_sm_and_holds_every_row(heads, kv, s, d):
    plan = pivot_scores.launch_plan(heads, kv, s, d)
    assert plan["smem_bytes"] <= 232_448
    assert 2 * (plan["smem_bytes"] + CTA_RESERVED) <= SM_SHARED
    assert plan["stages"] >= 2
    assert plan["bq"] % 64 == 0 and plan["bn"] == plan["bq"]  # one TMA box shape
    assert plan["block"] == 128 * (plan["bq"] // 64) + 32  # + the producer warp
    # the workspace holds one row statistic per (query head, row) of every
    # block launch 1 writes, the padding rows of the last block included,
    # and one column sum per (query head, key) of every block of launch 2
    padded = plan["rows"]["grid"][1] * plan["bq"]
    assert padded == plan["cols"]["grid"][1] * plan["bq"] >= s
    assert plan["workspace_floats"] == 2 * heads * padded


def test_pivot_plan_pins_the_kernels_plan():
    # 2B: 12/2 heads, S = 2304: 18 blocks of 128 rows / keys; 1024 bytes of
    # alignment slack, the 128 x 128 bf16 fixed block, 2 stages of a 128 x
    # 128 bf16 tile and 128 f32 statistics, 5 mbarriers; the merge's 256
    # keys per CTA
    plan = pivot_scores.launch_plan(12, 2, 2304, 128)
    assert plan == dict(rows=dict(grid=(12, 18)), cols=dict(grid=(6, 18, 2)),
                        merge=dict(grid=(9, 2), block=256),
                        block=288, bq=128, bn=128, stages=2,
                        smem_bytes=1024 + 32768 + 2 * (32768 + 512) + 40,
                        workspace_floats=2 * 12 * 2304)


@pytest.mark.parametrize("kw", [dict(d=80), dict(heads=17, num_kv=1), dict(heads=13),
                                dict(s=0), dict(num_kv=0)])
def test_pivot_plan_refuses_what_the_kernel_does_not_take(kw):
    args = dict(heads=12, num_kv=2, s=2304, d=128)
    args.update(kw)
    with pytest.raises(ValueError):
        pivot_scores.launch_plan(**args)
