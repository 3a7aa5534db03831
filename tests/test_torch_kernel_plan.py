"""The launch plans of K1 and K3 (``ops/cuda/{flash_prefill,vit_attention}.launch_plan``),
checked on the CPU.

The kernels cannot run here, but the plans they are launched with are plain
Python: the grid must cover every (head, query row) (K3: every slice, head
and patch row), the shared memory must fit one H100 block, the TMA ring
must have stages to overlap, and the query block must be whole 64-row
warpgroups.
"""

import numpy as np
import pytest

from retake_tpu_torch.ops.cuda import flash_prefill, vit_attention

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
