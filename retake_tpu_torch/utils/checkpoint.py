"""Pre-quantized parameter trees on disk (port of ``retake_tpu/utils/checkpoint.py``).

The same format as the JAX package's: one ``retake_quantized.safetensors``
file whose keys are the ``/``-joined tree paths, in the JAX tree's layouts
(linears ``[in, out]``, int8 ``{'w', 'scale'}`` pairs), and a small JSON
sidecar with the model name and quantization mode. A checkpoint written by
either package (``tools/quantize_checkpoint.py`` writes them) loads in the
other. The file goes through ``utils/safetensors_io.py``, so bf16 leaves
need neither the ``safetensors`` package nor ``ml_dtypes``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from retake_tpu_torch import device as device_lib
from retake_tpu_torch.utils import safetensors_io

FILENAME = "retake_quantized.safetensors"
META_FILENAME = "retake_quantized.json"


def _flatten(tree: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in tree.items():
        if "/" in str(k):
            raise ValueError(f"tree key {k!r} contains '/'")
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        elif v is not None:
            flat[key] = v
    return flat


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params(params: dict, out_dir: str, meta: Optional[dict] = None) -> None:
    """Write a parameter tree (nested dicts of tensors) to ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    safetensors_io.save_file(_flatten(params), os.path.join(out_dir, FILENAME))
    with open(os.path.join(out_dir, META_FILENAME), "w") as f:
        json.dump(meta or {}, f)


def has_params(path: str) -> bool:
    return os.path.exists(os.path.join(path, FILENAME))


def load_meta(path: str) -> dict:
    mp = os.path.join(path, META_FILENAME)
    if not os.path.exists(mp):
        return {}
    with open(mp) as f:
        return json.load(f)


def load_checked(path: str, rt, expect_model: str, device="cuda") -> dict:
    """Load a pre-quantized tree after the JAX loader's gates: the run's
    quantization mode must expect int8 weights, W8A8 needs a checkpoint
    with the vision linears quantized (``vit_int8``), and the sidecar's
    model family must be the engine's."""
    meta = load_meta(path)
    saved = str(meta.get("model_name", "")).lower().replace("-", "").replace("_", "")
    want = expect_model.lower().replace("-", "").replace("_", "")

    def fam(n):  # llava_onevision and llava_video share one layout
        return "llava" if n.startswith("llava") else n

    if saved and fam(saved) != fam(want):
        raise ValueError(f"{path} was quantized for model_name={meta.get('model_name')!r}, "
                         f"not {expect_model!r}")
    if rt.quantization not in ("int8", "w8a8"):
        raise ValueError(f"{path} holds int8 weights but the config requests "
                         f"quantization={rt.quantization!r}")
    if rt.quantization == "w8a8" and not meta.get("vit_int8"):
        raise ValueError("w8a8 config needs a checkpoint quantized with --vit")
    return load_params(path, device)


def load_params(path: str, device="cuda") -> dict:
    """A saved tree with every leaf on ``device``, read one tensor at a time."""
    dev = device_lib.resolve(device)
    f = safetensors_io.SafeFile(os.path.join(path, FILENAME))
    return _unflatten({k: f.tensor(k).to(dev) for k in f.keys()})
