"""Reading a device trace: busy time as the union of device intervals,
device time by name, idle gaps named by the host operation running."""

import pytest

from portbench.trace import Trace


def test_busy_union_and_gaps():
    ev = [dict(cat="kernel", name="flash_prefill_kernel<128>", ts=0.0, dur=10.0),
          dict(cat="kernel", name="gemm_a", ts=5.0, dur=10.0),   # overlaps: union 0-15
          dict(cat="gpu_memcpy", name="Memcpy DtoH", ts=30.0, dur=5.0),
          dict(cat="kernel", name="gemm_a", ts=60.0, dur=20.0),
          dict(cat="cpu_op", name="aten::item", ts=14.0, dur=20.0),
          dict(cat="cpu_op", name="aten::cat", ts=34.0, dur=40.0),
          dict(cat="cpu_op", name="aten::copy_", ts=36.0, dur=2.0)]
    t = Trace(ev, wall_s=100e-6)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.device_s(["gemm"]) == pytest.approx(30e-6)
    assert t.top_ops()[0] == ["gemm_a", pytest.approx(30e-6)]
    gaps = dict(t.idle_gaps())
    assert gaps == {"aten::item": pytest.approx(15e-6), "aten::cat": pytest.approx(25e-6)}
