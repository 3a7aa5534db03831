"""The yardstick's arithmetic: kernel counts against the figures of the
port's kernel table (PERF.md), the metric readers on a synthetic run."""

import types

import numpy as np
import pytest

from portbench import counts, readers, spec


def test_k1_matches_the_kernel_table():
    c = counts.k1_prefill(12, 2, 128, 20000, 2304)
    assert c["flops"] == pytest.approx(299e9, rel=2e-3)  # 0.303 ms at 989 TFLOP/s
    assert counts.bound_seconds(c) == pytest.approx(0.303e-3, rel=3e-3)


def test_k2_k3_k4_match_the_kernel_table():
    assert counts.k2_scores(12, 2, 128, 2304)["flops"] == pytest.approx(16.3e9, rel=3e-3)
    k3 = counts.k3_vit(128, 576, 16, 80)
    assert k3["bytes"] == pytest.approx(755e6, rel=2e-3)
    assert counts.bound_seconds(k3) == pytest.approx(0.2255e-3, rel=3e-3)
    k4 = counts.k4_decode(2, 6, 128, [55366])
    assert 2 * 2 * 55366 * 128 * 2 == pytest.approx(56.7e6, rel=1e-3)
    assert k4["bytes"] == pytest.approx(56.7e6, rel=2e-3)


def test_k4_live_columns():
    # prefill of 100, decode region [8192 + 4, 8192 + 10) with the write end at 8202
    assert counts.k4_live_columns([100, 50], [8196, 8202], 8202) == [106, 50]


def test_quantile_is_numpys_linear_rule():
    v = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert readers.quantile(v, 0.9) == pytest.approx(np.quantile(v, 0.9))
    assert readers.quantile(v, 0.5) == 3.0


def _run(**kw):
    base = dict(requests=[], results=[], stats={}, profiles={}, kernels={}, setup_s=1.0,
                window_s=None,
                traffic={}, config={}, family="qwen2_vl")
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_closed_loop_readers():
    reqs = [dict(ttft_s=2.0, wall_s=5.0, tokens=np.arange(32), stages={"vision_tower": 1.0}),
            dict(ttft_s=4.0, wall_s=7.1, tokens=np.arange(32), stages={"vision_tower": 3.0}),
            dict(ttft_s=3.0, wall_s=6.0, tokens=np.arange(32), stages={})]
    run = _run(requests=reqs)
    assert spec.metric_reader("ttft_s")(run) == 3.0
    assert spec.metric_reader("tpot_ms")(run) == pytest.approx(1e3 * 9.1 / 93)
    assert spec.metric_reader("vit_s")(run) == 2.0


def test_open_loop_readers():
    res = [dict(arrival_s=float(i), queue_wait_s=0.5, first_token_s=i + 1.0,
                finish_s=i + 2.0, tokens=np.arange(10), failed=False) for i in range(10)]
    run = _run(results=res, window_s=11.0, stats=dict(tokens_emitted=100, segments_dispatched=10,
                                                      segment_steps=8, batch_slots=4))
    assert spec.metric_reader("ttft_p90_s")(run) == pytest.approx(1.0)
    assert spec.metric_reader("output_tokens_per_s")(run) == pytest.approx(100 / 11.0)
    assert spec.metric_reader("serve.queue_wait_p50_s")(run) == pytest.approx(0.5)
    assert spec.metric_reader("serve.slot_occupancy")(run) == pytest.approx(100 * 100 / 320)
    res[9]["failed"] = True  # a failed request is beyond any limit
    res[8]["failed"] = True
    assert spec.metric_reader("ttft_p90_s")(run) is None


def test_prefill_mfu_of_the_full_cell():
    cell = spec.cell("qwen2-vl-7b.video-qa-1024f")
    run = _run(requests=[dict(ttft_s=10.0)], traffic=cell["traffic"], config=cell["config"])
    flops = readers.request_flops(run, 1024)
    assert 1.5e15 < flops < 3e15  # the reckoning of about 2.1 PFLOP
    assert spec.metric_reader("prefill_mfu")(run) == pytest.approx(
        100 * flops / (10.0 * counts.PEAK_BF16_FLOPS))


def test_roofline_reader_needs_calls_and_device_time():
    prof = types.SimpleNamespace(device_s=lambda names: 2 * 0.303e-3)
    call = dict(heads=12, kv=2, d=128, cache_len=20000, valid=2304, int8_kv=False)
    run = _run(profiles={"prefill": prof}, kernels={"k1": [call, call]})
    assert readers.roofline(run, "k1", "prefill") == pytest.approx(100.0, rel=3e-3)
    assert readers.roofline(run, "k2", "prefill") is None
