"""The general traffic generator: it reads a mix's parameters
(``portbench/traffic/<name>.json``) and makes the schedule and every
request's inputs from ``--seed``, on the device. A mix whose shape this
generator cannot make brings its own in ``portbench/traffic/<name>.py``
(see ``generator``).

A request is 16 random text ids, the video span, then a 48-id question
(the request layout of the port's ``tools/bench_model.py``); its pixels are
drawn on the device from a ``torch.Generator`` seeded from (seed, index).
The video span and the pixels are the model family's
(``portbench/families/<family>.py``: ``layout`` and ``request``).

Closed loop (``"loop": "closed"``): one client sends request i + 1 when
request i has finished; every request has ``frames`` frames and decodes
``max_new_tokens``. Open loop (``"loop": "open"``): ``round(rate_per_s *
seconds)`` requests are due in the window; request k of the multiset has
``frames[k % len(frames)]`` frames and ``output_tokens[k % len(...)]``
tokens. The gaps between arrivals are a fixed multiset too, the midpoint
quantiles of the exponential distribution (the spread of a Poisson
process's gaps) scaled to fill the window, the first arrival at its start.
The seed draws only the order of the requests and the order of the gaps,
so every seed offers the same work at the same rate.
"""

from __future__ import annotations

import sys
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

TEXT_IDS = (10, 1000)  # the range random text ids are drawn from


def _seed(*parts: int) -> int:
    return int(np.random.SeedSequence([int(p) % 2**63 for p in parts]).generate_state(1,
                                                                                     np.uint64)[0])


def schedule(traffic: dict, seed: int, seconds: float) -> List[dict]:
    """The open loop's requests due in a window of ``seconds``: dicts of
    index, frames, max_new_tokens and arrival_s, sorted by arrival."""
    n = max(1, round(traffic["rate_per_s"] * seconds))
    frames, outs = traffic["frames"], traffic["output_tokens"]
    kinds = [(frames[k % len(frames)], outs[k % len(outs)]) for k in range(n)]
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    rng = np.random.default_rng(_seed(seed, 7))
    order = rng.permutation(n)
    arrivals = np.concatenate([[0.0], np.cumsum(gaps[rng.permutation(n)])[:-1]])
    return [dict(index=i, frames=kinds[order[i]][0], max_new_tokens=kinds[order[i]][1],
                 arrival_s=float(arrivals[i])) for i in range(n)]


def family_module(family):
    """A model family's module (``portbench/families/<name>.py``): ``family``
    itself, or the module its name finds (``spec.family``)."""
    from portbench import spec

    return spec.family(family) if isinstance(family, str) else family


def text_ids(traffic: dict, seed: int, index: int):
    """Request ``index``'s random text ids before and after the video."""
    rng = np.random.default_rng(_seed(seed, index, 1))
    pre = rng.integers(*TEXT_IDS, size=traffic["prefix_tokens"])
    post = rng.integers(*TEXT_IDS, size=traffic["question_tokens"])
    return pre, post


def text_or_zeros(traffic: dict, pre=None, post=None):
    """``pre`` and ``post``, zeros of the mix's lengths where not given."""
    pre = np.zeros(traffic["prefix_tokens"], np.int64) if pre is None else pre
    post = np.zeros(traffic["question_tokens"], np.int64) if post is None else post
    return pre, post


def pixel_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator on ``device`` that request ``index``'s pixels are drawn
    from."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, index, 2) % 2**63)
    return gen


def chunk_frames(config: dict) -> Optional[int]:
    """Frames a prefill chunk, where the configuration chunks the prefill."""
    return config["retake"].get("longvideo_kwargs", {}).get("chunked_prefill_frames")


def layout(family, config: dict, traffic: dict, frames: int, pre=None, post=None):
    """(ids, grid, tokens per prefill chunk) of a request of ``frames``
    frames; ``pre`` / ``post`` are its text ids (zeros when only the
    layout is wanted). ``family`` is the family's module or its name;
    ``grid`` is its own (None where it has none)."""
    return family_module(family).layout(config, traffic, frames, pre, post)


def request(family, config: dict, traffic: dict, seed: int, index: int, frames: int,
            device) -> dict:
    """Request ``index``'s inputs, on ``device``: ``ids`` (numpy) and the
    family's pixels (``patches`` with ``grid``, or ``video``)."""
    return family_module(family).request(config, traffic, seed, index, frames, device)


HOOKS = ("schedule", "request")  # a mix's module may replace either
LOOP_HOOKS = ("loop", "samples")  # ...and bring a loop of its own with them


def generator(module=None) -> SimpleNamespace:
    """A mix's generator: ``schedule`` and ``request`` of the mix's own
    module (``portbench/traffic/<name>.py``) where it defines them, this
    module's otherwise. A module may also define ``loop(run, engine)``,
    which drives the window in place of the closed and open loops of
    ``portbench/run.py``, with ``samples(run)``, the records the check
    compares; both or neither."""
    own = sys.modules[__name__]
    fns = {f: getattr(module, f, None) or getattr(own, f) for f in HOOKS}
    loop: Optional[tuple] = None
    if module is not None and any(hasattr(module, f) for f in LOOP_HOOKS):
        loop = tuple(getattr(module, f) for f in LOOP_HOOKS)
    return SimpleNamespace(loop=loop, **fns)
