"""Build and load the port's CUDA kernels (``retake_tpu_torch/csrc/*.cu``).

All sources compile with one ``nvcc`` call for ``sm_90a`` into one shared
library with a plain C interface, loaded with ctypes (pointers and the
stream go in as ``c_void_p``, ints as ``c_int``). The build runs at first
use into ``retake_tpu_torch/_build/`` (gitignored), named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the existing library. Nothing is imported or compiled at module import.

Set ``RETAKE_NVCC_VERBOSE=1`` to print ptxas register / shared-memory use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# exported C functions: name -> argument types (all return int cudaError_t)
SIGNATURES = {
    "retake_flash_prefill_bf16": [_P] * 8 + [_I] * 5 + [_P],
    "retake_pivot_scores_bf16": [_P] * 5 + [_I] * 4 + [_P],
    "retake_vit_attention_bf16": [_P] * 4 + [_I] * 4 + [_P],
}

_lib = None
build_seconds = None  # wall seconds of the last compile (None: loaded as built)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libretake_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for these sources is missing."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc()] + NVCC_FLAGS + [f"-I{SRC_DIR}", "-o", str(tmp)]
    if os.environ.get("RETAKE_NVCC_VERBOSE", "") not in ("", "0"):
        cmd += ["-Xptxas", "-v"]
    cmd += [str(p) for p in cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    if proc.stderr.strip() and "-v" in cmd:
        print(proc.stderr)
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.retake_cuda_error_string.argtypes = [ctypes.c_int]
        lib.retake_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = library().retake_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
