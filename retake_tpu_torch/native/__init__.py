"""ctypes binding of the native host frame pipeline (port of
``retake_tpu/native``; the C++ is a copy of its ``framepipe.cpp``).

The source is split in two halves, each built at first use into
``retake_tpu_torch/_build/`` (gitignored) as a shared library named by a
hash of its sources and flags:

* ``"patchify"`` (``framepipe_patch.cpp``: ``rt_resize_nearest``,
  ``rt_patchify_qwen``) needs only ``g++``;
* ``"jpeg"`` (``framepipe_jpeg.cpp`` with the patch half compiled in:
  ``rt_decode_jpeg``, ``rt_load_frames``) also needs ``jpeglib.h`` and
  ``libjpeg``.

The flags are the JAX build's (``-O3 -std=c++17 -pthread -fPIC``, no
``-ffast-math``), so the frames and patches are bit-identical to the JAX
package's native path. A machine without ``g++``, or (for the JPEG half)
without libjpeg, leaves that half unbuilt (as does a library that will not
load: one built on another machine): its entry points raise
``NativeUnavailable`` and ``status()`` says why; callers catch exactly that
and take their PIL / numpy path. Any other build failure raises
``RuntimeError``. Each build writes a temporary file and ``os.replace``-s
it into place, so processes that build at once leave one loadable library.
Nothing is compiled at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_SOURCES = {  # part -> (sources, link flags)
    "patchify": (["framepipe_patch.cpp"], []),
    "jpeg": (["framepipe_jpeg.cpp", "framepipe_patch.cpp"], ["-ljpeg"]),
}
# the smallest program that needs what the JPEG half needs: a build failure
# of this probe means the machine lacks libjpeg, not that the source is wrong
_JPEG_PROBE = (b"#include <cstdio>\n#include <jpeglib.h>\nint main() {\n"
               b"  jpeg_decompress_struct c; jpeg_error_mgr e;\n"
               b"  c.err = jpeg_std_error(&e); jpeg_create_decompress(&c);\n"
               b"  jpeg_destroy_decompress(&c); return 0;\n}\n")

_P, _I = ctypes.POINTER, ctypes.c_int
_SIGNATURES = {
    "patchify": {
        "rt_patchify_qwen": [_P(ctypes.c_uint8)] + [_I] * 6 + [_P(ctypes.c_float)] * 3 + [_I],
    },
    "jpeg": {
        "rt_load_frames": [ctypes.c_char_p, _I, _I, _P(ctypes.c_uint8), _P(_I), _P(_I), _I],
        "rt_decode_jpeg": [ctypes.c_char_p, _P(ctypes.c_uint8), ctypes.c_long, _P(_I), _P(_I)],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_unavailable: Dict[str, str] = {}  # part -> why it cannot be built here


class NativeUnavailable(RuntimeError):
    """The native library (or the requested half) cannot be built here."""


def library_path(part: str) -> Path:
    sources, link = _SOURCES[part]
    h = hashlib.sha256(" ".join(CXX_FLAGS + link).encode())
    for name in sorted(set(sources) | {"framepipe.h"}):
        h.update(name.encode())
        h.update((_HERE / name).read_bytes())
    return BUILD_DIR / f"libframepipe_{part}_{h.hexdigest()[:16]}.so"


def _temp_name(path: Path) -> Path:
    return path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeUnavailable("no C++ compiler (g++ is not on PATH)")
    return gxx


def _jpeg_missing(gxx: str) -> Optional[str]:
    """Why the JPEG half cannot build on this machine, or None."""
    out = _temp_name(BUILD_DIR / "jpeg_probe")
    try:
        proc = subprocess.run([gxx, "-x", "c++", "-", "-ljpeg", "-o", str(out)],
                              input=_JPEG_PROBE, capture_output=True)
    finally:
        out.unlink(missing_ok=True)
    if proc.returncode == 0:
        return None
    msg = proc.stderr.decode(errors="replace").strip().splitlines()
    return "libjpeg is missing: " + (msg[0] if msg else f"g++ exit {proc.returncode}")


def _build(part: str) -> Path:
    so = library_path(part)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    gxx = _gxx()
    if part == "jpeg":
        missing = _jpeg_missing(gxx)
        if missing is not None:
            raise NativeUnavailable(missing)
    sources, link = _SOURCES[part]
    tmp = _temp_name(so)
    cmd = [gxx] + CXX_FLAGS + [str(_HERE / s) for s in sources] + link + ["-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def get_lib(part: str = "patchify") -> ctypes.CDLL:
    """The loaded library of one half (``"patchify"`` or ``"jpeg"``), built
    at first use; ``NativeUnavailable`` if this machine cannot build it."""
    if part not in _SOURCES:
        raise ValueError(f"part must be one of {tuple(_SOURCES)}, got {part!r}")
    with _lock:
        if part in _libs:
            return _libs[part]
        if part in _unavailable:
            raise NativeUnavailable(_unavailable[part])
        try:
            so = _build(part)
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:  # built elsewhere: a library it links is missing here
                raise NativeUnavailable(f"cannot load {so.name}: {e}") from e
        except NativeUnavailable as e:
            _unavailable[part] = str(e)
            raise
        for name, argtypes in _SIGNATURES[part].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[part] = lib
        return lib


def status() -> Dict[str, str]:
    """Each half's state on this machine (building it if needed):
    ``"built: <library file>"`` or ``"unavailable: <reason>"``."""
    out = {}
    for part in _SOURCES:
        try:
            get_lib(part)
            out[part] = f"built: {library_path(part).name}"
        except NativeUnavailable as e:
            out[part] = f"unavailable: {e}"
    return out


def probe_jpeg_size(path: str) -> Tuple[int, int]:
    from PIL import Image

    with Image.open(path) as img:
        return img.height, img.width


def load_frames(
    paths: List[str], resolution: int, threads: Optional[int] = None
) -> np.ndarray:
    """Decode JPEG frames + longest-side NEAREST resize -> [n, h, w, 3] u8.
    ``NativeUnavailable`` also when the library cannot decode them (a file
    that is no JPEG, frames of different sizes): the PIL path handles those."""
    if not paths:
        raise ValueError("no frames to load")
    lib = get_lib("jpeg")
    h0, w0 = probe_jpeg_size(paths[0])
    if max(h0, w0) > resolution and resolution > 0:
        factor = resolution / max(h0, w0)
        dh, dw = int(h0 * factor), int(w0 * factor)
    else:
        dh, dw = h0, w0
    out = np.empty((len(paths), dh, dw, 3), np.uint8)
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    oh, ow = ctypes.c_int(), ctypes.c_int()
    rc = lib.rt_load_frames(
        blob, len(paths), resolution,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(oh), ctypes.byref(ow),
        threads or os.cpu_count() or 1,
    )
    if rc != 0:
        raise NativeUnavailable(f"rt_load_frames failed rc={rc}")
    if (oh.value, ow.value) != (dh, dw):
        raise NativeUnavailable(f"libjpeg read {oh.value}x{ow.value}, PIL {dh}x{dw}")
    return out


def patchify_qwen(
    frames: np.ndarray,  # [T, H, W, 3] uint8, H/W multiples of ps*merge
    patch_size: int = 14,
    temporal_patch_size: int = 2,
    merge_size: int = 2,
    mean=None,
    std=None,
    threads: Optional[int] = None,
) -> np.ndarray:
    from retake_tpu_torch.data.processor import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD

    lib = get_lib("patchify")
    mean = np.asarray(mean if mean is not None else OPENAI_CLIP_MEAN, np.float32)
    std = np.asarray(std if std is not None else OPENAI_CLIP_STD, np.float32)
    if frames.dtype != np.uint8 or frames.ndim != 4 or frames.shape[3] != 3:
        raise ValueError(f"frames must be [T, H, W, 3] uint8, got {frames.dtype} "
                         f"{frames.shape}")
    t, h, w, _ = frames.shape
    unit = patch_size * merge_size
    if t < 1 or h % unit or w % unit or mean.shape != (3,) or std.shape != (3,):
        raise ValueError(f"frames {frames.shape} are not whole {unit}-pixel blocks, or "
                         "mean / std are not 3 channels")
    grid_t = -(-t // temporal_patch_size)
    gh, gw = h // patch_size, w // patch_size
    out = np.empty(
        (grid_t * gh * gw, 3 * temporal_patch_size * patch_size**2), np.float32
    )
    frames = np.ascontiguousarray(frames)
    rc = lib.rt_patchify_qwen(
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        t, h, w, patch_size, temporal_patch_size, merge_size,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        threads or os.cpu_count() or 1,
    )
    if rc != 0:
        raise NativeUnavailable(f"rt_patchify_qwen failed rc={rc}")
    return out
