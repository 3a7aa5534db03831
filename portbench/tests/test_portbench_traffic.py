"""The generator: the same seed gives the same schedule and inputs; an open
loop's window holds a fixed number of requests and a fixed multiset of
lengths, the seed drawing only their order and arrivals."""

from collections import Counter

import numpy as np
import pytest
import torch

from portbench import spec, traffic
from portbench.tests import tiny

SEEDS = [0, 2**31 + 17, 987654321987]


def test_schedule_is_deterministic_and_fixed_in_work():
    tr = spec.cell("qwen2-vl-7b.serve-clips")["traffic"]
    a = traffic.schedule(tr, SEEDS[1], 51)
    assert a == traffic.schedule(tr, SEEDS[1], 51)
    kinds = [Counter((r["frames"], r["max_new_tokens"]) for r in traffic.schedule(tr, s, 51))
             for s in SEEDS]
    assert kinds[0] == kinds[1] == kinds[2]
    assert len(a) == round(tr["rate_per_s"] * 51)
    b = traffic.schedule(tr, SEEDS[2], 51)
    assert [r["arrival_s"] for r in a] != [r["arrival_s"] for r in b]
    for r in a:
        assert 0 <= r["arrival_s"] < 51
    assert [r["arrival_s"] for r in a] == sorted(r["arrival_s"] for r in a)
    gaps = [sorted(np.round(np.diff([r["arrival_s"] for r in traffic.schedule(tr, s, 51)] + [51]),
                            9)) for s in SEEDS]
    assert gaps[0] == gaps[1] == gaps[2]  # one multiset of gaps, in another order


@pytest.mark.parametrize("family,config", [("qwen2_vl", tiny.qwen_config()),
                                           ("llava_video", tiny.llava_config())])
def test_request_inputs_are_deterministic(family, config):
    tr = tiny.video_qa(8)
    a = traffic.request(family, config, tr, SEEDS[2], 3, 8, "cpu")
    b = traffic.request(family, config, tr, SEEDS[2], 3, 8, "cpu")
    c = traffic.request(family, config, tr, SEEDS[2], 4, 8, "cpu")
    key = "patches" if family == "qwen2_vl" else "video"
    assert np.array_equal(a["ids"], b["ids"]) and torch.equal(a[key], b[key])
    assert not torch.equal(a[key], c[key])
    ids, _, _ = traffic.layout(family, config, tr, 8)
    assert len(ids) == len(a["ids"])


def test_full_size_layouts():
    q = spec.cell("qwen2-vl-7b.video-qa-1024f")
    ids, grid, chunk = traffic.layout("qwen2_vl", q["config"], q["traffic"], 1024)
    assert grid.tolist() == [[512, 32, 18]] and chunk == 2304
    assert int((ids == q["config"]["video_token_id"]).sum()) == 73728
    lv = spec.cell("llava-video-7b.video-qa-384f")
    ids, _, chunk = traffic.layout("llava_video", lv["config"], lv["traffic"], 384)
    assert int((ids == lv["config"]["video_token_index"]).sum()) == 384 * 196 + 1
    assert chunk == 6272


def test_closed_loop_check_takes_the_last_request():
    """The check compares the window's last request (the most served state
    behind it) and ``checked_requests`` - 1 more drawn from the seed."""
    import types

    from portbench import run as run_lib

    tr = spec.cell("qwen2-vl-7b.video-qa-1024f")["traffic"]
    picks = []
    for seed in SEEDS:
        run = types.SimpleNamespace(seed=seed, traffic=tr,
                                    requests=[dict(index=i) for i in range(6)])
        got = [r["index"] for r in run_lib.closed_samples(run)]
        assert got == [r["index"] for r in run_lib.closed_samples(run)]
        assert len(got) == tr["checked_requests"] >= 2 and got[-1] == 5
        picks.append(got)
    assert len({tuple(p) for p in picks}) > 1  # the rest is the seed's
    run = types.SimpleNamespace(seed=1, traffic=tr, requests=[dict(index=0)])
    assert [r["index"] for r in run_lib.closed_samples(run)] == [0]
