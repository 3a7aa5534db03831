"""The port's jax-free host data copies (``retake_tpu_torch/data/processor.py``
and ``data/video.py``) pinned to their originals in ``retake_tpu/data/``:
``smart_resize``, the patches of ``preprocess_video`` / ``preprocess_image``
against the original's numpy path (its native C++ fast paths made
unavailable by monkeypatching), ``Qwen2VLProcessor``'s ids, grids and
pixels, frame sampling, the longest-side resize, and ``fetch_video`` on a
JPEG frame directory against the original's PIL path; all exact. Also: the
new modules import neither jax nor the JAX package. A video file is
written and read with OpenCV.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from retake_tpu import native
from retake_tpu.data import processor as jproc
from retake_tpu.data import video as jvideo
from retake_tpu_torch.data import processor as tproc
from retake_tpu_torch.data import video as tvideo

REPO = Path(__file__).resolve().parents[1]


class StubTokenizer:
    def encode(self, s):
        return [20 + (b % 400) for b in s.encode()][:64]

    def decode(self, ids, **kw):
        return " ".join(str(int(i)) for i in ids)


@pytest.fixture
def no_native(monkeypatch):
    """The original takes its numpy / PIL paths: its native entry points
    raise, as they do where the library cannot be built."""

    def unavailable(*a, **kw):
        raise native.NativeUnavailable("disabled by the test")

    monkeypatch.setattr(native, "patchify_qwen", unavailable)
    monkeypatch.setattr(native, "load_frames", unavailable)


def _frames(rng, n, h, w):
    return [rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("hw", [(252, 448), (448, 252), (720, 1280), (1080, 1920), (56, 56),
                                (30, 2000), (28, 28)])
def test_smart_resize_copy_matches(hw):
    for kw in ({}, {"min_pixels": 1}, {"max_pixels": 200 * 200}):
        try:
            want = jproc.smart_resize(*hw, **kw)
        except ValueError:
            with pytest.raises(ValueError):
                tproc.smart_resize(*hw, **kw)
            continue
        assert tproc.smart_resize(*hw, **kw) == want


@pytest.mark.parametrize("n,h,w", [(4, 112, 196), (3, 84, 56), (1, 60, 90), (5, 252, 448)])
def test_preprocess_video_copy_matches_numpy_path(no_native, n, h, w):
    rng = np.random.default_rng(n * 1000 + h)
    frames = _frames(rng, n, h, w)
    want, wgrid = jproc.preprocess_video(frames, min_pixels=1)
    got, grid = tproc.preprocess_video(frames, min_pixels=1)
    assert grid == wgrid
    np.testing.assert_array_equal(got, want)


def test_preprocess_image_copy_matches_numpy_path(no_native, rng):
    img = _frames(rng, 1, 96, 140)[0]
    want, wgrid = jproc.preprocess_image(img)
    got, grid = tproc.preprocess_image(img)
    assert grid == wgrid
    np.testing.assert_array_equal(got, want)


def _processors(**kw):
    ids = dict(vision_start_token_id=3, vision_end_token_id=4, video_token_id=6,
               image_token_id=5, min_pixels=1, **kw)
    return jproc.Qwen2VLProcessor(StubTokenizer(), **ids), tproc.Qwen2VLProcessor(StubTokenizer(), **ids)


@pytest.mark.parametrize("kind", ["video", "images_and_video", "video_grid", "text"])
def test_processor_copy_matches(no_native, rng, kind):
    """input_ids, video_grid_thw, image_grid_thw and the pixels, exactly."""
    jp, tp = _processors()
    frames = _frames(rng, 4, 56, 84)
    images = _frames(rng, 2, 84, 56)
    args = {"video": dict(frames=frames), "images_and_video": dict(frames=frames, images=images),
            "video_grid": dict(video_grid=(2, 4, 6)), "text": {}}[kind]
    want, got = jp("What happens? A. x", **args), tp("What happens? A. x", **args)
    assert set(got) == set(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert tp.decode([20, 21]) == jp.decode([20, 21])
    assert tproc.CHAT_TEMPLATE == jproc.CHAT_TEMPLATE


@pytest.mark.parametrize("args", [(250, 2048, 4, 25), (1000, 64, 4, 25), (37, 2048, 4, 25),
                                  (8, 8, 2, 2.0), (8, 8, 2, 1.0), (3, 16, 30, 30), (100, 7, 1, 1)])
def test_frame_indices_copy_matches(args):
    np.testing.assert_array_equal(tvideo.get_frame_indices(*args), jvideo.get_frame_indices(*args))


@pytest.mark.parametrize("hw,res", [((252, 448), 224), ((448, 252), 448), ((90, 60), 84)])
def test_resize_longside_copy_matches(rng, hw, res):
    frame = _frames(rng, 1, *hw)[0]
    np.testing.assert_array_equal(tvideo.resize_longside(frame, res),
                                  jvideo.resize_longside(frame, res))


@pytest.fixture(scope="module")
def frame_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(56, 120, 3), dtype=np.uint8)
    for i in range(10):
        Image.fromarray(np.roll(base, i * 5, axis=1)).save(root / f"{i:06d}.jpg")
    return str(root)


@pytest.mark.parametrize("max_frames,fps,res", [(8, 2, 84), (4, 25, 448), (10, 1, 100)])
def test_fetch_video_frame_dir_copy_matches_pil_path(no_native, frame_dir, max_frames, fps, res):
    want = jvideo.fetch_video(frame_dir, max_frames, fps, res, extraction_fps=2.0)
    got = tvideo.fetch_video(frame_dir, max_frames, fps, res, extraction_fps=2.0)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tvideo.fetch_video(frame_dir, max_frames, fps, res)


@pytest.fixture(scope="module")
def video_file(tmp_path_factory):
    """A 20-frame MJPG file at 10 fps (OpenCV writes and reads it)."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path_factory.mktemp("video") / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (84, 56))
    rng = np.random.default_rng(1)
    for _ in range(20):
        writer.write(rng.integers(0, 255, size=(56, 84, 3), dtype=np.uint8))
    writer.release()
    return path


@pytest.mark.parametrize("max_frames,fps,res", [(8, 2, 64), (64, None, 84), (6, 30, 40)])
def test_fetch_video_file_copy_matches(video_file, max_frames, fps, res):
    """OpenCV decoding, fps-capped sampling and the longest-side resize of a
    video file, as the original (``fps`` None: the file's own rate)."""
    want = jvideo.fetch_video(video_file, max_frames, fps, res)
    got = tvideo.fetch_video(video_file, max_frames, fps, res)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tvideo.load_video_file(video_file + ".missing", 8)


def test_new_port_modules_import_no_jax():
    """The HTTP front end and the data copies import neither jax nor the
    JAX package (nor do the server and engine they pull in)."""
    code = (
        "import sys\n"
        "import retake_tpu_torch.runtime.http_server, retake_tpu_torch.data.processor\n"
        "import retake_tpu_torch.data.video, retake_tpu_torch.runtime.serve\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'retake_tpu' or m.startswith('retake_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
