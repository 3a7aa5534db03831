"""Qwen2-VL preprocessing: smart resize, patchify, chat template, tokenizer
(jax-free copy of ``retake_tpu/data/processor.py``).

Video frames -> normalized flattened patches in the spatial-merge block
order the vision tower expects, plus the prompt with the video placeholder
expanded to the token count of the processed grid. The tokenizer is passed
in (a HF tokenizer, or a stub in tests and on machines without one).

Copied without the original's native C++ normalize + patchify fast path
(``retake_tpu.native``, which the port may not import; the numpy path here
computes the same function) and without ``from_pretrained`` (loading a
tokenizer belongs with checkpoint loading, not ported yet). ``tests/test_torch_data.py`` pins this copy to
the original. PIL is imported lazily, as in the original.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

OPENAI_CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OPENAI_CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

DEFAULT_MIN_PIXELS = 56 * 56
DEFAULT_MAX_PIXELS = 14 * 14 * 4 * 1280

CHAT_TEMPLATE = (
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
    "<|im_start|>user\n{video}{question}<|im_end|>\n"
    "<|im_start|>assistant\n"
)


def preprocess_image(
    image: np.ndarray,  # [H, W, 3] uint8 (RGB)
    patch_size: int = 14,
    merge_size: int = 2,
    temporal_patch_size: int = 2,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """Still image -> (patches [gh*gw, C*tps*ps*ps], (1, gh, gw)).

    HF Qwen2VLImageProcessor tiles the image ``temporal_patch_size`` times so
    it flows through the same 3-D patchify as video — identical to a 1-frame
    video here (preprocess_video repeats the last frame to fill the temporal
    patch)."""
    return preprocess_video(
        [image], patch_size, merge_size, temporal_patch_size,
        min_pixels, max_pixels,
    )


def smart_resize(
    height: int,
    width: int,
    factor: int = 28,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
) -> Tuple[int, int]:
    """Round (h, w) to multiples of ``factor`` within the pixel budget."""
    if height < factor or width < factor:
        raise ValueError(f"image too small: {height}x{width} < factor {factor}")
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absurd aspect ratio")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def _resize_bicubic(frame: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    from PIL import Image

    img = Image.fromarray(frame)
    return np.asarray(img.resize((out_w, out_h), resample=Image.BICUBIC))


def preprocess_video(
    frames: Sequence[np.ndarray],  # T x [H, W, 3] uint8 (RGB)
    patch_size: int = 14,
    merge_size: int = 2,
    temporal_patch_size: int = 2,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """frames -> (flattened patches [grid_t*gh*gw, C*tps*ps*ps] f32,
    (grid_t, gh, gw))."""
    if not len(frames):
        raise ValueError("empty video")
    h0, w0 = frames[0].shape[:2]
    factor = patch_size * merge_size
    out_h, out_w = smart_resize(h0, w0, factor, min_pixels, max_pixels)

    resized = np.stack([_resize_bicubic(f, out_h, out_w) for f in frames])
    proc = resized.astype(np.float32) / 255.0
    proc = (proc - OPENAI_CLIP_MEAN) / OPENAI_CLIP_STD
    proc = proc.transpose(0, 3, 1, 2)  # [T, C, H, W]

    t = proc.shape[0]
    if t % temporal_patch_size:
        pad = temporal_patch_size - t % temporal_patch_size
        proc = np.concatenate([proc, np.repeat(proc[-1:], pad, axis=0)])
    grid_t = proc.shape[0] // temporal_patch_size
    c = proc.shape[1]
    gh, gw = out_h // patch_size, out_w // patch_size
    m, ps, tps = merge_size, patch_size, temporal_patch_size

    p = proc.reshape(grid_t, tps, c, gh // m, m, ps, gw // m, m, ps)
    p = p.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = p.reshape(grid_t * gh * gw, c * tps * ps * ps)
    return np.ascontiguousarray(flat), (grid_t, gh, gw)


class Qwen2VLProcessor:
    """Prompt building + video preprocessing.

    ``tokenizer`` must provide encode(str)->List[int] and decode(List[int])->
    str; a HF tokenizer works directly. Special video tokens are inserted by
    id, so the tokenizer never needs to know them.
    """

    def __init__(
        self,
        tokenizer,
        *,
        vision_start_token_id: int = 151652,
        vision_end_token_id: int = 151653,
        video_token_id: int = 151656,
        image_token_id: int = 151655,
        patch_size: int = 14,
        merge_size: int = 2,
        temporal_patch_size: int = 2,
        min_pixels: int = DEFAULT_MIN_PIXELS,
        max_pixels: int = DEFAULT_MAX_PIXELS,
    ):
        self.tokenizer = tokenizer
        self.vision_start_token_id = vision_start_token_id
        self.vision_end_token_id = vision_end_token_id
        self.video_token_id = video_token_id
        self.image_token_id = image_token_id
        self.patch_size = patch_size
        self.merge_size = merge_size
        self.temporal_patch_size = temporal_patch_size
        self.min_pixels = min_pixels
        self.max_pixels = max_pixels

    def __call__(
        self,
        question: str,
        frames: Optional[Sequence[np.ndarray]] = None,
        images: Optional[Sequence[np.ndarray]] = None,
        video_grid: Optional[Sequence[int]] = None,
    ):
        """Returns dict(input_ids, pixel_values_videos, video_grid_thw[,
        pixel_values, image_grid_thw]). Still images precede the video in the
        prompt (reference content order: vision blocks, then the question).

        ``video_grid`` (a (t, h, w) patch grid from a previous call's
        ``video_grid_thw``) emits the video placeholder tokens WITHOUT
        reprocessing pixels — for re-asking about an already-encoded video
        (engine.encode_video / VideoFeatures reuse); ``pixel_values_videos``
        is None in that case."""
        pixel = grid = None
        vision_ids: List[int] = []
        img_pixels = img_grids = None
        if images:
            flats, grids = [], []
            for img in images:
                flat, g = preprocess_image(
                    img, self.patch_size, self.merge_size,
                    self.temporal_patch_size, self.min_pixels, self.max_pixels,
                )
                flats.append(flat)
                grids.append(g)
                n_tok = (g[0] * g[1] * g[2]) // self.merge_size**2
                vision_ids += (
                    [self.vision_start_token_id]
                    + [self.image_token_id] * n_tok
                    + [self.vision_end_token_id]
                )
            img_pixels = np.concatenate(flats, axis=0)
            img_grids = np.asarray(grids)
        if frames is not None:
            pixel, grid = preprocess_video(
                frames,
                self.patch_size,
                self.merge_size,
                self.temporal_patch_size,
                self.min_pixels,
                self.max_pixels,
            )
        elif video_grid is not None:
            grid = tuple(int(x) for x in np.asarray(video_grid).reshape(-1)[:3])
        if grid is not None:
            n_tokens = (grid[0] * grid[1] * grid[2]) // self.merge_size**2
            vision_ids += (
                [self.vision_start_token_id]
                + [self.video_token_id] * n_tokens
                + [self.vision_end_token_id]
            )
        pre, post = CHAT_TEMPLATE.split("{video}")
        post = post.format(question=question)
        input_ids = (
            list(self.tokenizer.encode(pre))
            + vision_ids
            + list(self.tokenizer.encode(post))
        )
        return {
            "input_ids": np.asarray(input_ids, np.int64),
            "pixel_values_videos": pixel,
            "video_grid_thw": None if grid is None else np.asarray([grid]),
            "pixel_values": img_pixels,
            "image_grid_thw": img_grids,
        }

    def decode(self, token_ids) -> str:
        return self.tokenizer.decode(
            [int(t) for t in token_ids], skip_special_tokens=True
        )
