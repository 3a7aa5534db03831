"""The draws a model family's parameter tree is made of
(``portbench/families/<family>.py``: ``tree``), from ``--seed``, on the
device, in the served type (bf16), one ``torch.randn`` per stacked leaf.

The layout is the one the program takes (its ``params`` trees: linears
input-major ``[in, out]``, per-layer leaves stacked ``[L, ...]``); both the
program and the plain reference read these same tensors. Matrices are
N(0, 1 / fan_in); biases N(0, 0.1²) and norm scales 1 + N(0, 0.1²), so that
the reference's bias and norm handling is exercised; embeddings N(0, 0.02²).
"""

from __future__ import annotations

import math

import torch


class Draw:
    def __init__(self, seed: int, device, dtype=torch.bfloat16):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % 2**63)
        self.device, self.dtype = device, dtype

    def normal(self, shape, std: float, mean: float = 0.0) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, device=self.device, dtype=torch.float32)
        return (x.mul_(std).add_(mean)).to(self.dtype)

    def linear(self, *shape, bias: bool = True) -> dict:
        out = {"w": self.normal(shape, 1.0 / math.sqrt(shape[-2]))}
        if bias:
            out["b"] = self.normal(shape[:-2] + shape[-1:], 0.1)
        return out

    def norm(self, *shape) -> torch.Tensor:
        return self.normal(shape, 0.1, 1.0)

    def layer_norm(self, *shape) -> dict:
        return {"scale": self.norm(*shape), "bias": self.normal(shape, 0.1)}


def text_tree(draw: Draw, c: dict) -> dict:
    """A Qwen2 decoder: q/k/v with biases, o / gate / up / down without."""
    d, m, l = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"]
    hd = d // c["num_attention_heads"]
    kv = c["num_key_value_heads"] * hd
    layers = {
        "input_ln": draw.norm(l, d),
        "q": draw.linear(l, d, d),
        "k": draw.linear(l, d, kv),
        "v": draw.linear(l, d, kv),
        "o": draw.linear(l, d, d, bias=False),
        "post_ln": draw.norm(l, d),
        "gate": draw.linear(l, d, m, bias=False),
        "up": draw.linear(l, d, m, bias=False),
        "down": draw.linear(l, m, d, bias=False),
    }
    tree = {"layers": layers, "final_ln": draw.norm(d),
            "embed_tokens": draw.normal((c["vocab_size"], d), 0.02)}
    if not c.get("tie_word_embeddings", False):
        tree["lm_head"] = draw.normal((d, c["vocab_size"]), 1.0 / math.sqrt(d))
    return tree
