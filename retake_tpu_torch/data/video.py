"""Video ingestion on the host: frame sampling and loading (jax-free copy
of ``retake_tpu/data/video.py``).

* Even-count fps-capped sampling (``get_frame_indices``): n = floor(min(
  total, max_frames, total / extraction_fps * fps)) rounded down to even,
  indices = linspace(0, total - 1, n).
* Frame directories (pre-extracted, ``%06d.jpg``): the same formula, and
  only the files at those indices are read.
* Longest-side resize with NEAREST resampling (only shrinks).

A frame directory of JPEGs decodes through the port's native library
(``retake_tpu_torch.native``: libjpeg and the C++ NEAREST resize, many
threads) where it builds, exactly where the original takes its native fast
path; where libjpeg is missing (``NativeUnavailable``) frames decode
through PIL, as the original's do there. PIL and OpenCV are imported
lazily, as in the original. ``tests/test_torch_data.py`` and
``tests/test_torch_native.py`` pin this copy to the original.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Union

import numpy as np

from retake_tpu_torch import native


def get_frame_indices(
    total_frames: int,
    max_num_frames: int,
    sample_fps: float,
    extraction_fps: float,
) -> np.ndarray:
    sample_frames = float(total_frames / extraction_fps) * sample_fps
    sample_frames = min(total_frames, max_num_frames, sample_frames)
    sample_frames = math.floor(sample_frames)
    sample_frames = int(sample_frames / 2) * 2
    return np.linspace(0, total_frames - 1, sample_frames).astype(np.int32)


def resize_longside(frame: np.ndarray, resolution: int) -> np.ndarray:
    """Shrink so max(h, w) <= resolution (NEAREST, parity with reference)."""
    from PIL import Image

    h, w = frame.shape[:2]
    if max(h, w) <= resolution:
        return frame
    factor = resolution / max(h, w)
    out_w, out_h = int(w * factor), int(h * factor)
    img = Image.fromarray(frame)
    return np.asarray(img.resize((out_w, out_h), resample=Image.NEAREST))


def load_video_file(
    path: str,
    max_num_frames: int,
    sample_fps: Optional[float] = None,
) -> List[np.ndarray]:
    """Decode sampled frames from a video file via OpenCV (RGB uint8)."""
    import cv2

    if path.startswith("file://"):
        path = path[7:]
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"could not open video: {path}")
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = cap.get(cv2.CAP_PROP_FPS)
    indices = get_frame_indices(total, max_num_frames, sample_fps or fps, fps)
    frames = []
    for idx in indices:
        cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
        ok, frame = cap.read()
        if ok:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return frames


def load_frame_dir(
    video_root: str,
    max_num_frames: int,
    sample_fps: float,
    extraction_fps: float,
    resolution: Optional[int] = None,
) -> List[np.ndarray]:
    """Load sampled frames from a pre-extracted frame directory
    (%06d.jpg naming; reference dataset_utils.py:68-83)."""
    from PIL import Image

    files = sorted(os.listdir(video_root))
    total = len(files)
    n = len(get_frame_indices(total, max_num_frames, sample_fps, extraction_fps))
    indices = sorted(
        set(np.linspace(0, total - 1, n).astype(np.int32).tolist())
    )
    paths = [os.path.join(video_root, files[i]) for i in indices]

    # fast path: native multi-threaded JPEG decode + NEAREST resize
    if all(p.lower().endswith((".jpg", ".jpeg")) for p in paths):
        try:
            return list(native.load_frames(paths, resolution or 0))
        except native.NativeUnavailable:
            pass

    frames = []
    for p in paths:
        frame = np.asarray(Image.open(p).convert("RGB"))
        if resolution is not None:
            frame = resize_longside(frame, resolution)
        frames.append(frame)
    return frames


def fetch_video(
    video_path: str,
    max_num_frames: int,
    sample_fps: float,
    longsize_resolution: int,
    extraction_fps: Optional[float] = None,
) -> List[np.ndarray]:
    """Reference fetch_video (demo.py:113-117): load + longest-side resize."""
    if os.path.isdir(video_path):
        if extraction_fps is None:
            raise ValueError("a frame directory needs its extraction_fps")
        return load_frame_dir(
            video_path, max_num_frames, sample_fps, extraction_fps,
            longsize_resolution,
        )
    frames = load_video_file(video_path, max_num_frames, sample_fps)
    return [resize_longside(f, longsize_resolution) for f in frames]
