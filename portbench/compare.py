"""The comparison that decides ``correct``: what the program served against
the plain reference, position by position.

At each position p of a served stream (the first token, then each decode
step) the program's own logits P (those its timed path computed) and the
reference's R, computed on the same prompt and the same served prefix:

* ``rel_rms``: the root mean square of P - R over the vocabulary, over the
  standard deviation of R: how far the program's arithmetic has drifted;
* ``gap``: how far the served token's reference logit lies below the
  reference's best (0 where the program served the reference's choice);
* ``dev``: the largest distance between the program's and the reference's
  logit of any token. A greedy token is the argmax of P, so its gap is at
  most 2 dev whatever the precision: ``excess`` = (gap - 2 dev)+ / std(R)
  is 0 unless the served token is not the one the program's logits chose.

The compared number, ``logit_err``, is the worst position's larger of
``rel_rms`` and ``excess``: drifted arithmetic shows in the first, a token
altered where it is produced in the second. ``gap`` and ``dev`` are
reported beside it.
"""

from __future__ import annotations

import numpy as np
import torch


def readings(ref: torch.Tensor, prog, tokens) -> dict:
    """ref [n, V] and prog [n, V] (None: not captured) at the n served
    ``tokens``; the worst position's readings."""
    ref = ref.float()
    toks = torch.as_tensor(np.asarray(tokens, dtype=np.int64), device=ref.device)
    gap = ref.max(dim=-1).values - ref.gather(1, toks[:, None])[:, 0]
    out = {"gap": float(gap.max())}
    if prog is None:
        out.update(dev=float("inf"), rel_rms=float("inf"), excess=float("inf"),
                   logit_err=float("inf"))
        return out
    diff = prog.to(ref.device).float() - ref
    std = ref.std(dim=-1)
    dev = diff.abs().max(dim=-1).values
    rel = diff.pow(2).mean(-1).sqrt() / std
    excess = (gap - 2 * dev).clamp_min(0) / std
    out.update(dev=float(dev.max()), rel_rms=float(rel.max()), excess=float(excess.max()),
               logit_err=float(torch.maximum(rel, excess).max()))
    return out


def worst(readings_list) -> dict:
    """Each reading's largest over several requests."""
    keys = sorted({k for r in readings_list for k in r})
    return {k: max(r[k] for r in readings_list if k in r) for k in keys}
