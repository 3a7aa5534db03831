"""safetensors files read and written with torch and json alone.

The layout: a little-endian u64 header size N, an N-byte JSON header
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` of strings), then the raw little-endian bytes,
offsets relative to the end of the header. bf16 goes through
``torch.frombuffer(...).view(torch.bfloat16)``: numpy has no bf16, so the
port neither needs the ``safetensors`` package nor ``ml_dtypes``.
``SafeFile`` reads one tensor at a time, so a loader can move each to the
device before it reads the next.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}


class SafeFile:
    """One safetensors file: its header, and each tensor read on demand."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        self.metadata = header.pop("__metadata__", None) or {}
        self.header = header
        self.data_start = 8 + n

    def keys(self):
        return list(self.header)

    def tensor(self, name: str) -> torch.Tensor:
        """The tensor ``name`` on the host (its own copy of the bytes)."""
        info = self.header[name]
        dtype, shape = DTYPES[info["dtype"]], info["shape"]
        begin, end = info["data_offsets"]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        with open(self.path, "rb") as f:
            f.seek(self.data_start + begin)
            buf = bytearray(f.read(end - begin))
        return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).reshape(shape)


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on the host."""
    f = SafeFile(path)
    return {k: f.tensor(k) for k in f.keys()}


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write host or device tensors (any layout) as one safetensors file."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
