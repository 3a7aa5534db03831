"""Benchmark datasets: annotation-JSON loading + frame-dir sampling
(jax-free copy of ``retake_tpu/data/datasets.py``).

Mirrors the reference's ``BaseDataset`` contract (retake/dataset_utils.py:
22-98): annotation files hold ``messages`` (question/answer), ``videos``
(pre-extracted frame directory), and ``meta`` (possibly JSON-encoded string).
Items are (idx, {question, video frames}, meta) with meta['answer'] filled
from the reference answer. Frame sampling is the port's ``data/video.py``.
``tests/test_torch_eval.py`` pins this copy to the original.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

from retake_tpu_torch.data import video as video_lib


class BaseDataset:
    def __init__(self, anno_file: str, processor_kwargs: Dict[str, Any]):
        self.processor_kwargs = processor_kwargs
        with open(anno_file) as f:
            self.annos = json.load(f)
        for anno in self.annos:
            if isinstance(anno.get("meta"), str):
                anno["meta"] = json.loads(anno["meta"])

    def __len__(self) -> int:
        return len(self.annos)

    def video_key(self, idx: int) -> str:
        """Identity of a sample's video (frame directory) without loading
        frames — the eval runner groups same-video questions with it when
        ``reuse_video_features`` is on."""
        return self.annos[idx]["videos"][0]

    def item_light(self, idx: int) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
        """__getitem__ without the frame load (question + meta only), for
        samples whose video is already encoded (VideoFeatures reuse)."""
        anno = self.annos[idx]
        question = anno["messages"][0]["content"].replace("<video>", "")
        meta = dict(anno["meta"])
        meta["answer"] = anno["messages"][1]["content"]
        return idx, {"question": question, "video": None}, meta

    def __getitem__(self, idx: int) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
        anno = self.annos[idx]
        question = anno["messages"][0]["content"].replace("<video>", "")
        frames = video_lib.load_frame_dir(
            anno["videos"][0],
            max_num_frames=self.processor_kwargs["video_maxlen"],
            sample_fps=self.processor_kwargs["video_fps"],
            extraction_fps=self.processor_kwargs["video_frame_extraction_fps"],
            resolution=self.processor_kwargs["image_resolution"],
        )
        meta = dict(anno["meta"])
        meta["answer"] = anno["messages"][1]["content"]
        return idx, {"question": question, "video": frames}, meta


def get_dataset(dataset_name: str, anno_file: str, processor_kwargs) -> BaseDataset:
    if dataset_name.lower() in ("videomme", "mlvu", "lvbench"):
        return BaseDataset(anno_file, processor_kwargs)
    raise NotImplementedError(dataset_name)
