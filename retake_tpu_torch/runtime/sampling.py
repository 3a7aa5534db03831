"""Token selection: greedy argmax, or seeded temperature / top-k / top-p
sampling (port of ``_select_token`` in ``retake_tpu/runtime/engine.py``).

The JAX engine draws with ``jax.random.categorical``, which is
``argmax(logits + gumbel_noise)``. Here the Gumbel noise is an explicit
input: ``Sampler.noise`` makes one fp32 row per draw from a
``torch.Generator`` on the logits' device, seeded only from (seed, stream,
step). Stream ``FIRST`` is the prefill's first token, stream ``LOOP`` the
decode step counted from the request's own first decode step (the JAX
engine's ``fold_in(key(seed), 0)`` and ``fold_in(fold_in(key(seed), 1),
step)``). A request's draws therefore never depend on the batch it decodes
in. torch's generator cannot reproduce JAX's stream; ``Sampler.noise_fn``
takes another source of the same signature (the parity tests feed JAX's
Gumbel draws through it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

FIRST, LOOP = 0, 1  # noise streams: the first token, the decode loop


def filter_logits(logits: torch.Tensor, temperature: float, top_p: float, top_k: int) -> torch.Tensor:
    """fp32 logits [..., V] after temperature, top-k and top-p, with HF
    LogitsWarper semantics: top-k keeps every logit >= the k-th largest,
    top-p the smallest prefix of the descending-sorted distribution whose
    probability covers ``top_p`` (at least one token), with every logit
    equal to the cutoff. Dropped entries are -inf."""
    logits = logits.to(torch.float32)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=logits.device)
    if temperature != 1.0:
        logits = logits / torch.tensor(temperature, dtype=torch.float32, device=logits.device)
    if top_k:
        kth = torch.topk(logits, min(int(top_k), logits.shape[-1]), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        p = torch.tensor(top_p, dtype=torch.float32, device=logits.device)
        n_keep = ((cum - probs) < p).sum(dim=-1, keepdim=True).clamp_min(1)
        cutoff = sorted_desc.gather(-1, n_keep - 1)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return logits


def _generator_seed(seed: int, stream: int, step: int) -> int:
    """One 64-bit generator seed per (seed, stream, step), well mixed."""
    words = np.random.SeedSequence(
        [int(seed) & (2**64 - 1), int(stream), max(int(step), 0)]
    ).generate_state(2, np.uint32)
    return (int(words[0]) << 32) | int(words[1])


def gumbel_noise(seed: int, stream: int, step: int, vocab: int, device) -> torch.Tensor:
    """Standard Gumbel draws, fp32 [vocab], from a generator on ``device``
    seeded from (seed, stream, step): ``-log(-log(u))`` with ``u`` uniform
    in [tiny, 1), as ``jax.random.gumbel`` draws them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_generator_seed(seed, stream, step))
    u = torch.rand(vocab, generator=gen, device=device, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@dataclasses.dataclass(frozen=True)
class Sampler:
    """``RetakeConfig``'s sampling settings and the noise source."""

    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0
    # (seed, stream, step, vocab, device) -> fp32 [vocab]; None = gumbel_noise
    noise_fn: Optional[Callable] = None

    @classmethod
    def from_config(cls, rt, noise_fn: Optional[Callable] = None) -> Optional["Sampler"]:
        """The config's sampler, or None (greedy) without ``do_sample``."""
        if not rt.do_sample:
            return None
        return cls(float(rt.temperature), float(rt.top_p), int(rt.top_k), int(rt.seed), noise_fn)

    def noise(self, stream: int, steps: Sequence[int], vocab: int, device) -> torch.Tensor:
        """fp32 [len(steps), vocab]: one noise row per draw."""
        fn = self.noise_fn or gumbel_noise
        rows = [torch.as_tensor(fn(self.seed, stream, int(s), vocab, device), dtype=torch.float32)
                for s in steps]
        return torch.stack(rows).to(device)

    def select(self, logits: torch.Tensor, stream: int, steps: Sequence[int]) -> torch.Tensor:
        """Tokens [B] (int64) for logits [B, V], row b drawn at ``steps[b]``."""
        filtered = filter_logits(logits, self.temperature, self.top_p, self.top_k)
        noise = self.noise(stream, steps, logits.shape[-1], logits.device)
        return torch.argmax(filtered + noise, dim=-1)


def select_tokens(logits: torch.Tensor, sampler: Optional[Sampler], stream: int,
                  steps: Sequence[int]) -> torch.Tensor:
    """Greedy argmax over logits [B, V] (``sampler`` None) or the sampler's
    draws; tokens [B] int64 on the logits' device."""
    if sampler is None:
        return torch.argmax(logits, dim=-1)
    return sampler.select(logits, stream, steps)
