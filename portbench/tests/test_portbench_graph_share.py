"""``decode.graph_share`` on synthetic traces: the share of the traced
request's ``decode.step`` spans holding a ``decode.replay`` span, and
nothing where the trace has no decode step, as a program without the
graph path leaves it."""

import types

import pytest

from portbench import spec
from portbench.trace import Trace


def ann(name, ts, dur):
    return dict(cat="user_annotation", name="retake::" + name, ts=float(ts), dur=float(dur))


def share(events):
    run = types.SimpleNamespace(profiles={"request": Trace(events, 1e-3)})
    return spec.metric_reader("decode.graph_share")(run)


def steps(n, replayed):
    """``n`` decode steps 100 us apart; those in ``replayed`` hold a replay."""
    ev = [dict(cat="kernel", name="gemm", ts=0.0, dur=10.0)]
    for i in range(n):
        ev.append(ann("decode.step", 100 * i, 50))
        if i in replayed:
            ev.append(ann("decode.replay", 100 * i + 10, 30))
    return ev


@pytest.mark.parametrize("replayed,want", [
    (range(8), 1.0),  # all
    ((), 0.0),  # none
    (range(1, 8), 7 / 8),  # the first eager, the rest replayed
    ((2, 5), 2 / 8),
])
def test_share_of_replayed_steps(replayed, want):
    assert share(steps(8, set(replayed))) == pytest.approx(want)


def test_a_replay_outside_every_step_counts_for_none():
    ev = steps(4, set()) + [ann("decode.replay", 1000, 10)]
    assert share(ev) == 0.0


def test_nothing_without_decode_steps():
    assert share([dict(cat="kernel", name="gemm", ts=0.0, dur=10.0)]) is None
    assert share([ann("decode.replay", 0, 10)]) is None
    assert spec.metric_reader("decode.graph_share")(types.SimpleNamespace(profiles={})) is None
