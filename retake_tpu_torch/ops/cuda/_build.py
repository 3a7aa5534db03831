"""Build and load the port's CUDA kernels (``retake_tpu_torch/csrc/*.cu``).

Each source compiles in its own ``nvcc`` process for ``sm_90a``, all
started together, and one more ``nvcc`` links the objects into one shared
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
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# exported C functions: name -> argument types (all return int cudaError_t)
SIGNATURES = {
    "retake_flash_prefill_bf16": [_P] * 8 + [_I] * 5 + [_P],
    "retake_flash_prefill_int8": [_P] * 12 + [_I] * 5 + [_P],
    "retake_pivot_scores_bf16": [_P] * 5 + [_I] * 4 + [_P],
    "retake_vit_attention_bf16": [_P] * 4 + [_I] * 4 + [_P],
    "retake_decode_gapped_bf16": [_P] * 8 + [_I] * 6 + [_P],
    "retake_decode_gapped_int8": [_P] * 10 + [_I] * 6 + [_P],
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
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    verbose = os.environ.get("RETAKE_NVCC_VERBOSE", "") not in ("", "0")
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in cu:
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc] + NVCC_FLAGS + [f"-I{SRC_DIR}", "-c", "-o", str(obj), str(src)]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True)))
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
        elif verbose and err.strip():
            print(err)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc] + ARCH_FLAGS + ["-shared", "-o", str(tmp)] + [str(o) for o in objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{proc.stdout}\n{proc.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
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
    """The current CUDA stream of ``t``'s device, as a raw pointer (the
    call PyTorch's own generated launchers make: no Stream object)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)
