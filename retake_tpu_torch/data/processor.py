"""Qwen2-VL preprocessing: smart resize, patchify, chat template, tokenizer
(jax-free copy of ``retake_tpu/data/processor.py``).

Video frames -> normalized flattened patches in the spatial-merge block
order the vision tower expects, plus the prompt with the video placeholder
expanded to the token count of the processed grid. The tokenizer is passed
in (a HF tokenizer, or a stub in tests and on machines without one).

``LlavaOnevisionVideoProcessor`` does the same for LLaVA-OneVision /
LLaVA-Video: square frames, anyres image tiles, the placeholder span of
frames x tokens per frame + 1. ``from_pretrained`` loads a HF tokenizer
(``transformers`` is imported inside it).

``preprocess_video`` normalizes and patchifies in one native C++ pass
(``retake_tpu_torch.native``, the original's fast path, bit-identical to
it) and takes the numpy path only where the library cannot be built
(``NativeUnavailable``), as the original does. ``tests/test_torch_data.py``,
``tests/test_torch_native.py`` and ``tests/test_torch_llava.py`` pin this
copy to the original. PIL is imported lazily, as in the original.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from retake_tpu_torch import native

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
    # fast path: one native pass of normalize + patchify (the numpy path
    # makes several full passes over the frames)
    try:
        flat = native.patchify_qwen(resized, patch_size, temporal_patch_size, merge_size)
        grid_t = -(-resized.shape[0] // temporal_patch_size)
        return flat, (grid_t, out_h // patch_size, out_w // patch_size)
    except native.NativeUnavailable:
        pass

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

    @staticmethod
    def from_pretrained(path: str, **kwargs) -> "Qwen2VLProcessor":
        from transformers import AutoTokenizer

        return Qwen2VLProcessor(AutoTokenizer.from_pretrained(path), **kwargs)

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


class LlavaOnevisionVideoProcessor:
    """LLaVA-OneVision / LLaVA-Video preprocessing.

    HF LlavaOnevisionVideoProcessor semantics: every frame is resized to a
    square image_size x image_size (bicubic); normalization to [-1, 1] happens
    on the device (models/llava_onevision/siglip.patchify_frames). The
    prompt's single video placeholder expands to frames * tokens_per_frame + 1
    tokens (+1 = image_newline).
    """

    def __init__(
        self,
        tokenizer,
        *,
        video_token_id: int = 151647,
        image_token_id: int = 151646,
        image_size: int = 384,
        patch_size: int = 14,
        tokens_per_frame: int = 196,
        image_grid_pinpoints=None,
        vision_aspect_ratio: str = "anyres_max_9",
    ):
        from retake_tpu_torch.models.llava_onevision.config import LlavaOnevisionConfig

        self.tokenizer = tokenizer
        self.video_token_id = video_token_id
        self.image_token_id = image_token_id
        self.image_size = image_size
        self.patch_size = patch_size
        self.tokens_per_frame = tokens_per_frame
        self.image_grid_pinpoints = tuple(
            tuple(p) for p in (image_grid_pinpoints or LlavaOnevisionConfig.image_grid_pinpoints)
        )
        self.vision_aspect_ratio = vision_aspect_ratio

    @staticmethod
    def from_pretrained(path: str, **kwargs) -> "LlavaOnevisionVideoProcessor":
        from transformers import AutoTokenizer

        return LlavaOnevisionVideoProcessor(AutoTokenizer.from_pretrained(path), **kwargs)

    def _resize_square(self, frame: np.ndarray) -> np.ndarray:
        from PIL import Image

        s = self.image_size
        if frame.shape[0] == s and frame.shape[1] == s:
            return frame
        img = Image.fromarray(frame)
        return np.asarray(img.resize((s, s), resample=Image.BICUBIC))

    def __call__(self, question: str, frames=None, images=None,
                 num_frames: Optional[int] = None):
        """``num_frames`` emits the video placeholder tokens without
        reprocessing pixels (VideoFeatures reuse; see Qwen2VLProcessor's
        ``video_grid``): ``pixel_values_videos`` is None in that case."""
        from retake_tpu_torch.models.llava_onevision import anyres

        vision_ids: List[int] = []
        pixels = None
        img_tiles = img_sizes = None
        if images:
            grid_side = self.image_size // self.patch_size
            tiles_list, sizes = [], []
            for img in images:
                tiles, hw = anyres.image_to_anyres_tiles(
                    img, tile_size=self.image_size, pinpoints=self.image_grid_pinpoints,
                )
                tiles_list.append(tiles)
                sizes.append(hw)
                n_tok = anyres.packed_token_count(
                    hw, grid_side=grid_side, pinpoints=self.image_grid_pinpoints,
                    tile_size=self.image_size, vision_aspect_ratio=self.vision_aspect_ratio,
                )
                vision_ids += [self.image_token_id] * n_tok
            max_p = max(t.shape[0] for t in tiles_list)
            img_tiles = np.zeros(
                (len(tiles_list), max_p, self.image_size, self.image_size, 3), np.uint8
            )
            for i, t in enumerate(tiles_list):
                img_tiles[i, : t.shape[0]] = t
            img_sizes = np.asarray(sizes)
        if frames is not None:
            pixels = np.stack([self._resize_square(f) for f in frames])
            num_frames = len(frames)
        if num_frames is not None:
            vision_ids += [self.video_token_id] * (num_frames * self.tokens_per_frame + 1)
        pre, post = CHAT_TEMPLATE.split("{video}")
        post = post.format(question=question)
        input_ids = (
            list(self.tokenizer.encode(pre)) + vision_ids + list(self.tokenizer.encode(post))
        )
        return {
            "input_ids": np.asarray(input_ids, np.int64),
            "pixel_values_videos": pixels,
            "video_grid_thw": None,
            "pixel_values": img_tiles,
            "image_sizes": img_sizes,
        }

    def decode(self, token_ids) -> str:
        return self.tokenizer.decode([int(t) for t in token_ids], skip_special_tokens=True)
