"""Spans and stage times (port of ``retake_tpu/utils/profiling.py``).

``span(name, **attrs)`` marks one stretch of host work. While
``torch.profiler`` records, it opens ``record_function("retake::" + name)``
with its attrs (host values, never a device read) as the range's args
string; the range lands in the Chrome trace as a ``user_annotation`` on the
profiler's clock, which is also the device kernels' clock, so an idle gap of
the device is named by the innermost ``retake::`` span running when it
began. (The Chrome export of torch 2.11 and 2.13 keeps a range's name, not
its args string.) Spans nest by scope: the span that caused a span encloses
it, so the spans of one admission lie inside its ``serve.admit``, which
carries the request id. Off (no profiler recording), a span costs one
``torch.autograd._profiler_enabled()`` check and a flag test.

``StageTimer`` (on under RETAKE_PROFILE=1, or ``enabled=True``) adds up
seconds per engine stage (``vision_tower``, ``dpselect``,
``projector_pool``, ``prefill_chunks``, ``first_token``, ``decode``, ...),
each stage a span too. On a CUDA device a stage records a CUDA event on the
current stream at its start and at its end, so nothing waits at a stage
boundary and a stage's seconds are the device's, from where the stream
reached its start to where it reached its end. ``totals`` resolves them when
it is read, after one synchronize of the last end event (the engines read it
where they wait for the device anyway). Elsewhere the host clock.
"""

from __future__ import annotations

import functools
import os
import time
from collections import defaultdict
from typing import Dict

import torch

PREFIX = "retake::"  # the names of the port's ranges in a trace
_profiler_enabled = torch.autograd._profiler_enabled


class span:
    """``with span(name, **attrs):`` one ``retake::<name>`` range while the
    profiler records; nothing else."""

    __slots__ = ("name", "attrs", "_range")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs, self._range = name, attrs, None

    def __enter__(self):
        if _profiler_enabled():
            args = ",".join(f"{k}={v}" for k, v in self.attrs.items())
            self._range = torch.profiler.record_function(PREFIX + self.name, args or None)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False


def spanned(name: str):
    """Decorator: each call of the function is one ``name`` span."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


class _Stage(span):
    """A span whose start and end marks go to a ``StageTimer``."""

    __slots__ = ("timer", "key", "_start")

    def __init__(self, name: str, timer: "StageTimer", key: str, attrs: dict):
        super().__init__(name, **attrs)
        self.timer, self.key = timer, key

    def __enter__(self):
        super().__enter__()
        self._start = self.timer._mark()
        return self

    def __exit__(self, *exc):
        self.timer._marks.append((self.key, self._start, self.timer._mark()))
        return super().__exit__(*exc)


class StageTimer:
    def __init__(self, enabled: bool | None = None, device=None):
        self.enabled = (
            enabled
            if enabled is not None
            else os.environ.get("RETAKE_PROFILE", "") not in ("", "0")
        )
        self.device = torch.device(device) if device is not None else None
        self.cuda = self.device is not None and self.device.type == "cuda"
        self._totals: Dict[str, float] = defaultdict(float)
        self._marks: list = []  # (key, start, end) not yet in the totals

    def stage(self, name: str, key: str | None = None, **attrs) -> span:
        """The span ``name`` (``attrs`` its args), timed under ``key``
        (default ``name``) when the timer is on."""
        if not self.enabled:
            return span(name, **attrs)
        return _Stage(name, self, key or name, attrs)

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    @property
    def totals(self) -> Dict[str, float]:
        """Seconds per stage key (and whatever a caller stored beside them)."""
        if self._marks:
            if self.cuda:
                self._marks[-1][2].synchronize()
            for key, start, end in self._marks:
                self._totals[key] += start.elapsed_time(end) / 1e3 if self.cuda else end - start
            self._marks.clear()
        return self._totals
