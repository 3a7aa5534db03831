"""Host-side M-RoPE position indexing (numpy), jax-free copy.

Copy of ``retake_tpu/utils/positions.py`` — Qwen2-VL ``get_rope_index``
semantics, modality segmentation and the visual-compression position
reforge — kept in the port so it runs without the JAX package.
``tests/test_torch_config.py`` holds the copy to the original's outputs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def get_rope_index(
    input_ids: np.ndarray,  # [S] int
    *,
    spatial_merge_size: int,
    image_token_id: int,
    video_token_id: int,
    vision_start_token_id: int,
    image_grid_thw: Optional[np.ndarray] = None,  # [n, 3]
    video_grid_thw: Optional[np.ndarray] = None,  # [n, 3]
) -> Tuple[np.ndarray, int]:
    """Returns (position_ids [3, S] int32, rope_delta).

    Text tokens advance all three axes together; a vision block of (t, h, w)
    patches gets (temporal, row, col) grid coordinates offset so its minimum
    continues the running sequence; text after a block resumes at
    max(position) + 1.
    """
    s = len(input_ids)
    if image_grid_thw is None and video_grid_thw is None:
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, s)).copy()
        return pos, 0

    tokens = input_ids.tolist()
    m = spatial_merge_size
    pieces: List[np.ndarray] = []
    st = 0
    image_idx = video_idx = 0

    def last_max() -> int:
        return int(pieces[-1].max()) + 1 if pieces else 0

    while True:
        try:
            ed_image = tokens.index(image_token_id, st)
        except ValueError:
            ed_image = s + 1
        try:
            ed_video = tokens.index(video_token_id, st)
        except ValueError:
            ed_video = s + 1
        if ed_image > s and ed_video > s:
            break
        if ed_image < ed_video:
            t, h, w = (int(x) for x in image_grid_thw[image_idx])
            image_idx += 1
            ed = ed_image
        else:
            t, h, w = (int(x) for x in video_grid_thw[video_idx])
            video_idx += 1
            ed = ed_video
        gh, gw = h // m, w // m
        text_len = ed - st
        st_idx = last_max()
        if text_len:
            rng = np.arange(text_len, dtype=np.int32) + st_idx
            pieces.append(np.broadcast_to(rng, (3, text_len)).copy())
            st_idx = st_idx + text_len
        t_index = np.repeat(np.arange(t, dtype=np.int32), gh * gw)
        h_index = np.tile(np.repeat(np.arange(gh, dtype=np.int32), gw), t)
        w_index = np.tile(np.arange(gw, dtype=np.int32), t * gh)
        pieces.append(np.stack([t_index, h_index, w_index]) + st_idx)
        st = ed + t * gh * gw

    if st < s:
        st_idx = last_max()
        rng = np.arange(s - st, dtype=np.int32) + st_idx
        pieces.append(np.broadcast_to(rng, (3, s - st)).copy())

    pos = np.concatenate(pieces, axis=1).astype(np.int32)
    if pos.shape[1] != s:
        raise ValueError(
            "Vision features and vision tokens do not match: positions for "
            f"{pos.shape[1]} tokens vs sequence length {s} "
            "(check image/video_grid_thw against the placeholder counts)"
        )
    return pos, int(pos.max()) + 1 - s


def segment_modalities(
    input_ids: np.ndarray, video_token_id: int
) -> List[Tuple[int, int, str]]:
    """[(start, end, 'text'|'video'), ...] covering [0, S) in order."""
    is_video = input_ids == video_token_id
    segments: List[Tuple[int, int, str]] = []
    s = 0
    for i in range(1, len(input_ids) + 1):
        if i == len(input_ids) or is_video[i] != is_video[s]:
            segments.append((s, i, "video" if is_video[s] else "text"))
            s = i
    return segments


def reforge_after_visual_compression(
    input_ids: np.ndarray,  # [S]
    position_ids: np.ndarray,  # [3, S]
    video_span: Tuple[int, int],  # [s_index, e_index+1) of video tokens
    tgt_seq_len: int,  # video tokens kept
    num_frame_diff: int,  # grid_t - tgt_grid_t
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop the tail of the video-token span after DPSelect frame dropping
    and shift trailing temporal positions down by the removed frame count."""
    s_index, e_end = video_span
    keep_end = s_index + tgt_seq_len
    new_ids = np.concatenate([input_ids[:keep_end], input_ids[e_end:]])
    new_pos = np.concatenate(
        [position_ids[:, :keep_end], position_ids[:, e_end:]], axis=1
    ).copy()
    new_pos[:, keep_end:] -= num_frame_diff
    return new_ids, new_pos
