"""The port's native host frame pipeline (``retake_tpu_torch/native``)
against the JAX package's (``retake_tpu/native``), on this machine's
``g++`` and libjpeg: ``patchify_qwen`` and ``load_frames`` bit-identical on
the same inputs (a NEAREST downscale too), and the port's
``load_frame_dir`` / ``fetch_video`` / ``preprocess_video`` bit-identical to
the JAX package's default path, with nothing monkeypatched. Also: with the
JPEG half unavailable (libjpeg missing) the patchify half still builds and
is used while frames decode through PIL; a first build by several
processes at once leaves one loadable library; a file that libjpeg cannot
decode takes the PIL path instead of ending the process. Each test skips
only where ``g++`` is absent (or, for a JAX comparison, where the JAX
library cannot build).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from retake_tpu import native as jnative
from retake_tpu.data import processor as jproc
from retake_tpu.data import video as jvideo
from retake_tpu_torch import native
from retake_tpu_torch.data import processor as tproc
from retake_tpu_torch.data import video as tvideo

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine: the native library cannot build")


@pytest.fixture(scope="module")
def jax_lib(gxx):
    try:
        return jnative.get_lib()
    except jnative.NativeUnavailable as e:
        pytest.skip(f"the JAX package's native library cannot build here: {e}")


def _write_frames(root: Path, n: int, h: int, w: int, quality: int, seed: int = 0):
    """``n`` JPEG frames of smooth content plus noise (a camera-like
    spectrum, so libjpeg's and PIL's decoders have something to disagree on)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        base = np.stack([(xx * (3 + c) + yy * (2 + i) + 40 * c) % 256 for c in range(3)], -1)
        noise = rng.integers(-20, 20, size=(h, w, 3))
        img = np.clip(base + noise, 0, 255).astype(np.uint8)
        Image.fromarray(img).save(root / f"{i:06d}.jpg", quality=quality)
    return [str(root / f"{i:06d}.jpg") for i in range(n)]


@pytest.mark.parametrize("t,h,w", [(4, 56, 84), (5, 56, 84), (1, 28, 28), (3, 252, 448)])
def test_patchify_bit_identical_to_jax_native(jax_lib, t, h, w):
    """The port's C++ patchify (odd T repeats the last frame) equals the JAX
    package's bit for bit, and the numpy path within 1e-5."""
    frames = np.random.default_rng(t * h).integers(0, 255, size=(t, h, w, 3), dtype=np.uint8)
    got = native.patchify_qwen(frames)
    np.testing.assert_array_equal(got, jnative.patchify_qwen(frames))
    np.testing.assert_array_equal(native.patchify_qwen(frames, threads=1), got)
    want, _ = tproc.preprocess_video(list(frames), min_pixels=1, max_pixels=10**9)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("hw,res,quality", [((120, 160), 448, 95), ((360, 640), 448, 90),
                                            ((300, 400), 200, 75), ((251, 448), 448, 90)])
def test_load_frames_bit_identical_to_jax_native(jax_lib, tmp_path, hw, res, quality):
    """libjpeg decode + NEAREST resize (a downscale in two cases, none in
    two): the JAX package's frames bit for bit, on one thread and on many."""
    paths = _write_frames(tmp_path, 4, *hw, quality)
    want = jnative.load_frames(paths, res)
    got = native.load_frames(paths, res)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.load_frames(paths, res, threads=1), want)


@pytest.fixture(scope="module")
def camera_dir(tmp_path_factory):
    """12 frames of 640x360 at quality 90: the longest-side resize to 448
    downscales, where PIL's path and the native one differ."""
    root = tmp_path_factory.mktemp("camera")
    _write_frames(root, 12, 360, 640, 90, seed=3)
    return str(root)


@pytest.mark.parametrize("max_frames,fps,res", [(8, 4, 448), (12, 25, 224), (6, 2, 1000)])
def test_frame_dir_pipeline_matches_jax_default_path(jax_lib, camera_dir, max_frames, fps, res):
    """``load_frame_dir``, ``fetch_video`` and ``preprocess_video`` of the
    port equal the JAX package's default path (its native library) exactly,
    and the PIL path would not (the case this repairs)."""
    want = jvideo.load_frame_dir(camera_dir, max_frames, fps, 4, res)
    got = tvideo.load_frame_dir(camera_dir, max_frames, fps, 4, res)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    fetched = tvideo.fetch_video(camera_dir, max_frames, fps, res, extraction_fps=4)
    for g, w in zip(fetched, jvideo.fetch_video(camera_dir, max_frames, fps, res,
                                                extraction_fps=4)):
        np.testing.assert_array_equal(g, w)
    flat, grid = tproc.preprocess_video(got)
    want_flat, want_grid = jproc.preprocess_video(want)
    assert grid == want_grid
    np.testing.assert_array_equal(flat, want_flat)
    if res < 640:
        pil = [tvideo.resize_longside(np.asarray(Image.open(p).convert("RGB")), res)
               for p in sorted(Path(camera_dir).iterdir())[:1]]
        assert not np.array_equal(pil[0], got[0])


@pytest.fixture
def fresh_native(monkeypatch, tmp_path):
    """The port's native module with nothing built or cached: its build
    directory is a temporary one."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_unavailable", {})
    return tmp_path / "_build"


def test_without_libjpeg_the_patchify_half_builds_and_is_used(gxx, fresh_native, camera_dir,
                                                              monkeypatch):
    """libjpeg missing (the probe fails): ``status`` names the reason, the
    JPEG half raises ``NativeUnavailable`` and frames decode through PIL
    (the JAX package's PIL path), while ``preprocess_video`` still runs the
    native patchify (its patches are the native ones, not numpy's)."""
    monkeypatch.setattr(native, "_jpeg_missing", lambda gxx: "libjpeg is missing: test")
    st = native.status()
    assert st["patchify"].startswith("built:")
    assert st["jpeg"] == "unavailable: libjpeg is missing: test"
    assert [p.name for p in fresh_native.glob("*.so")] == [native.library_path("patchify").name]
    with pytest.raises(native.NativeUnavailable, match="libjpeg"):
        native.load_frames([str(Path(camera_dir) / "000000.jpg")], 448)
    frames = tvideo.load_frame_dir(camera_dir, 8, 4, 4, 448)
    for i, p in enumerate(sorted(Path(camera_dir).iterdir())[:1]):
        pil = jvideo.resize_longside(np.asarray(Image.open(p).convert("RGB")), 448)
        np.testing.assert_array_equal(frames[i], pil)
    calls = []
    orig = native.patchify_qwen
    monkeypatch.setattr(native, "patchify_qwen", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    flat, _ = tproc.preprocess_video(frames)
    assert calls == [1]
    resized = np.stack([tproc._resize_bicubic(f, 252, 448) for f in frames])
    np.testing.assert_array_equal(flat, orig(resized))


def test_no_compiler_leaves_both_halves_unavailable(fresh_native, monkeypatch, camera_dir):
    """Without ``g++`` nothing builds and both halves say why; the data
    paths take PIL and numpy (the JAX package's fallback)."""
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    st = native.status()
    assert all(v.startswith("unavailable: no C++ compiler") for v in st.values()), st
    frames = tvideo.load_frame_dir(camera_dir, 4, 4, 4, 224)
    flat, grid = tproc.preprocess_video(frames)
    assert flat.shape[0] == grid[0] * grid[1] * grid[2]
    assert not fresh_native.exists() or not list(fresh_native.glob("*.so"))


def test_a_library_that_will_not_load_is_unavailable(gxx, fresh_native):
    """A JPEG half built on another machine whose libjpeg this one lacks
    (here: a file that is no library) is unavailable, not an error; the
    patchify half still builds."""
    fresh_native.mkdir(parents=True)
    native.library_path("jpeg").write_bytes(b"not a shared library")
    st = native.status()
    assert st["jpeg"].startswith("unavailable: cannot load"), st
    assert st["patchify"].startswith("built:")


_BUILD_SCRIPT = r"""
import sys
from pathlib import Path
import numpy as np
from retake_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
frames = np.full((2, 28, 28, 3), 7, np.uint8)
print(float(native.patchify_qwen(frames).sum()), native.library_path("patchify").name)
"""


def test_concurrent_first_build_yields_one_loadable_library(gxx, tmp_path):
    """Four processes build the patchify half into one empty directory at
    once: each loads a working library, one file remains, no temporary."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_SCRIPT, str(tmp_path)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(out.split())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert len({tuple(o) for o in outs}) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [outs[0][1]]


def test_undecodable_jpeg_takes_the_pil_path(gxx, tmp_path):
    """A PNG named ``.jpg``: libjpeg's fatal error returns through setjmp
    (``NativeUnavailable``), and ``load_frame_dir`` decodes it with PIL."""
    img = np.random.default_rng(0).integers(0, 255, size=(40, 60, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "000000.jpg", format="PNG")
    Image.fromarray(img).save(tmp_path / "000001.jpg", format="PNG")
    with pytest.raises(native.NativeUnavailable, match="rc=-1"):
        native.load_frames([str(tmp_path / "000000.jpg")], 0)
    frames = tvideo.load_frame_dir(str(tmp_path), 2, 1, 1, None)
    assert len(frames) == 2
    np.testing.assert_array_equal(frames[0], img)
