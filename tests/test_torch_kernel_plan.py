"""K1's launch plan (``ops/cuda/flash_prefill.launch_plan``), checked on the CPU.

The kernel cannot run here, but the plan it is launched with is plain
Python: the grid must cover every (query head, query row), the shared
memory must fit one H100 block, the TMA ring must have stages to overlap,
and the query block must be whole 64-row warpgroups.
"""

import numpy as np
import pytest

from retake_tpu_torch.ops.cuda import flash_prefill

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
