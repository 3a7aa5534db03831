"""``Qwen2VLModel``: the text decoder plus the vision tower as one module.

Its parameter names are the JAX parameter tree's keys with ``.`` for ``/``
(``layers.q.w``, ``visual.blocks.qkv.w``, ...), so a state dict lines up
with ``retake_tpu.models.qwen2_vl.params`` leaf for leaf; the one layout
change is the head-major ``visual.blocks.qkv`` (see vision.py).
"""

from __future__ import annotations

from retake_tpu_torch.models.qwen2_vl.config import Qwen2VLConfig
from retake_tpu_torch.models.qwen2_vl.text import TextDecoder
from retake_tpu_torch.models.qwen2_vl.vision import VisionTower


class Qwen2VLModel(TextDecoder):
    def __init__(self, cfg: Qwen2VLConfig, params: dict):
        super().__init__(cfg, params)
        self.visual = VisionTower(cfg.vision, params["visual"])

    @property
    def device(self):
        return self.embed_tokens.device

    @property
    def dtype(self):
        return self.embed_tokens.dtype
