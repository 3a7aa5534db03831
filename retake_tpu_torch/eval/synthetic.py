"""What a local run of the eval runner needs where no benchmark, tokenizer
or cluster is at hand: JPEG frame directories with a Video-MME annotation
file in the reference's layout (the layout scripts/build_videomme_dataset.py
writes), a word-level tokenizer built offline, and a free local port for
``--coordinator``.
"""

from __future__ import annotations

import json
import os
import socket
from typing import Sequence


def save_offline_tokenizer(path: str, vocab_size: int = 512) -> None:
    """A word-level HF tokenizer saved into ``path``: ids 1 to
    ``vocab_size - 1`` are words starting with one of A-G; id 0 is
    ``[UNK]``, and ids past the vocabulary decode to nothing."""
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"[UNK]": 0, **{f"{'ABCDEFG'[i % 7]}{i}": i for i in range(1, vocab_size)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]").save_pretrained(
        path)


def write_frames(root: str, n: int, width: int, height: int, seed: int, block: int = 1) -> None:
    """``n`` JPEG frames (``%06d.jpg``) of a random texture of
    ``block`` x ``block`` pixel cells that drifts 3 pixels a frame."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, size=(height // block, width // block, 3), dtype=np.uint8)
    base = base.repeat(block, 0).repeat(block, 1)
    for i in range(n):
        Image.fromarray(np.roll(base, 3 * i, axis=1)).save(os.path.join(root, f"{i:06d}.jpg"),
                                                            quality=90)


def write_videomme(root: str, questions: Sequence[int], n_frames: int, width: int, height: int,
                   seed: int = 0, block: int = 1) -> str:
    """One frame directory ``root/vid{v}`` of ``n_frames`` frames for each
    entry of ``questions``, that many multiple-choice questions about it,
    and their annotation file ``root/videomme.json``; returns its path."""
    annos = []
    for v, n_q in enumerate(questions):
        vdir = os.path.join(root, f"vid{v}")
        os.makedirs(vdir)
        write_frames(vdir, n_frames, width, height, seed + v, block)
        for q in range(n_q):
            annos.append({
                "messages": [
                    {"role": "user", "content": f"<video>What happens in part {q} of clip {v}? "
                                                "A. one B. two C. three D. four"},
                    {"role": "assistant", "content": "ABCD"[(v + q) % 4]},
                ],
                "videos": [vdir],
                "meta": json.dumps({"task_type": f"t{q}", "domain": "d",
                                    "duration": ("short", "medium", "long")[v % 3],
                                    "question": f"Part {q} of clip {v}?"}),
            })
    anno_file = os.path.join(root, "videomme.json")
    with open(anno_file, "w") as f:
        json.dump(annos, f)
    return anno_file


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
