"""The readers of the program's ``retake::`` spans on synthetic traces:
each metric's value where the spans are there, and nothing (not zero)
where the trace holds none, as a program without them leaves it."""

import types

import pytest

from portbench import spec
from portbench.trace import Trace


def ann(name, ts, dur):
    return dict(cat="user_annotation", name="retake::" + name, ts=float(ts), dur=float(dur))


def kernel(ts, dur):
    return dict(cat="kernel", name="gemm", ts=float(ts), dur=float(dur))


def run_of(**profiles):
    return types.SimpleNamespace(profiles=profiles)


def read(name, run):
    return spec.metric_reader(name)(run)


# 1000 us of serving: a wait 100-400 us (a kernel 350-450 half inside it),
# two segments (50, 150 us), two harvests (20, 30 us), two admissions
SERVE = [kernel(0, 50), kernel(350, 100), kernel(600, 200),
         ann("serve.admit", 0, 90), ann("serve.segment", 10, 50), ann("serve.harvest", 60, 20),
         ann("serve.wait", 100, 300),
         ann("serve.admit", 400, 400), ann("serve.segment", 500, 150),
         ann("serve.harvest", 700, 30), dict(cat="cpu_op", name="aten::mm", ts=10.0, dur=5.0)]
BARE = [kernel(0, 50), kernel(350, 100), kernel(600, 200),
        dict(cat="cpu_op", name="aten::mm", ts=10.0, dur=5.0)]


def test_serve_readers():
    run = run_of(serve=Trace(SERVE, wall_s=1000e-6))
    # busy 350 us, 50 of them inside the 300 us wait: 1 - 300 / 700
    assert read("device_idle.serve_loaded", run) == pytest.approx(100 * (1 - 300 / 700))
    assert read("serve.segment_enqueue_ms", run) == pytest.approx(0.1)  # median of 50, 150 us
    assert read("serve.harvest_share", run) == pytest.approx(100 * 50 / 700)
    assert read("serve.admit_p50_s", run) == pytest.approx(245e-6)


def test_serve_loaded_without_waits_is_the_plain_idle_share():
    run = run_of(serve=Trace([e for e in SERVE if "wait" not in e["name"]], wall_s=1000e-6))
    assert read("device_idle.serve_loaded", run) == pytest.approx(100 * (1 - 350 / 1000))
    assert read("serve.harvest_share", run) == pytest.approx(100 * 50 / 1000)


def test_decode_step_reader():
    ev = [kernel(0, 10)] + [ann("decode.step", 100 * i, 40 + 10 * i) for i in range(5)]
    assert read("decode.step_enqueue_ms", run_of(request=Trace(ev, 1e-3))) == pytest.approx(0.06)


@pytest.mark.parametrize("name", ["device_idle.serve_loaded", "serve.segment_enqueue_ms",
                                  "serve.harvest_share", "serve.admit_p50_s",
                                  "decode.step_enqueue_ms"])
def test_nothing_without_spans(name):
    """A trace without the program's spans, or no trace: None."""
    assert read(name, run_of()) is None
    assert read(name, run_of(serve=Trace(BARE, 1e-3), request=Trace(BARE, 1e-3))) is None
