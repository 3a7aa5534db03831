"""``LlavaOnevisionModel``: the Qwen2 text decoder (1-D RoPE) plus the
SigLIP tower, the projector and ``image_newline`` as one module.

Parameter names are the JAX tree's keys with ``.`` for ``/``
(``layers.q.w``, ``vision_tower.blocks.q.w``, ``projector.linear_1.w``);
int8 linear weights are stored column-major (``col_major_int8``). ``tp``:
a ``TensorParallel`` handle, with ``params`` the rank's ``shard_params``
slice (SigLIP and the projector are whole).
"""

from __future__ import annotations

from torch import nn

from retake_tpu_torch.models.llava_onevision.config import LlavaOnevisionConfig
from retake_tpu_torch.models.qwen2_vl.params import ParamTree
from retake_tpu_torch.models.qwen2_vl.text import TextDecoder
from retake_tpu_torch.ops.quantization import col_major_int8


class LlavaOnevisionModel(TextDecoder):
    def __init__(self, cfg: LlavaOnevisionConfig, params: dict, tp=None):
        super().__init__(cfg.text, params, tp)
        self.vision_tower = ParamTree(col_major_int8(params["vision_tower"]))
        self.projector = ParamTree(col_major_int8(params["projector"]))
        self.image_newline = nn.Parameter(params["image_newline"], requires_grad=False)

    @property
    def vision_int8(self) -> bool:
        """Are the SigLIP block linears int8 (``quantize_siglip_int8``)?"""
        return "scale" in self.vision_tower.blocks.q
