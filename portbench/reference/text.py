"""Plain float32 reference of the ReTaKe text path: the Qwen2 decoder
(M-RoPE or 1-D RoPE, YaRN), chunked prefill with PivotKV eviction and
position reforge, and greedy decode through the compressed cache.

Written from the published descriptions (Qwen2-VL and ReTaKe papers, the
HF Qwen2 / Qwen2-VL modelling code) in plain ``torch`` operations; it
imports nothing of the program. Matrix products run in float32 with TF32
off (``run.py`` sets that for the process).

The work is layer-major: every chunk's input to layer l is known once layer
l - 1 has run for all chunks, so a layer's projections and MLP run over all
rows at once and only attention and eviction step through the chunks in
order, each against the cache that layer holds. The served tokens after
the first are one more chunk, attending to the compressed cache causally:
the same logits as decoding them one by one.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

MLP_ROWS = 8192  # rows of the MLP at a time (its intermediate is 4x wider in f32)


# ---------- the plan and positions ----------


def compression_ratio(retake: dict, seq_len: int) -> float:
    """PivotKV's keep ratio: dynamic (a cap of ``max_input_length`` cached
    tokens) or fixed; 1.0 without KV compression."""
    lv = retake.get("longvideo_kwargs", {})
    if not lv.get("kvcache_compression"):
        return 1.0
    kv = lv.get("kvcache_compression_kwargs", {})
    if kv.get("dynamic_compression_ratio"):
        cap = kv["max_input_length"]
        return 1.0 if seq_len <= cap else cap / seq_len
    return kv.get("compression_ratio") or 1.0


def plan(ids: np.ndarray, video_token_id: int, chunk_tokens: Optional[int],
         ratio: float) -> List[dict]:
    """The prefill's steps: each text segment whole, the video span in
    chunks of ``chunk_tokens``; a video chunk of ``valid`` tokens keeps
    ``max(1, int(ratio * valid))`` of them when ``ratio < 1``."""
    is_vid = ids == video_token_id
    cuts = np.flatnonzero(np.diff(is_vid.astype(np.int8))) + 1
    bounds = [0, *cuts.tolist(), len(ids)]
    steps, cache_len = [], 0
    for s, e in zip(bounds[:-1], bounds[1:]):
        if not is_vid[s] or chunk_tokens is None:
            steps.append(dict(start=s, valid=e - s, keep=e - s, compress=False,
                              cache_len=cache_len))
            cache_len += e - s
            continue
        for c in range(s, e, chunk_tokens):
            valid = min(chunk_tokens, e - c)
            compress = ratio < 1.0
            keep = max(1, int(ratio * valid)) if compress else valid
            steps.append(dict(start=c, valid=valid, keep=keep, compress=compress,
                              cache_len=cache_len))
            cache_len += keep
    return steps


def mrope_positions(ids: np.ndarray, video_token_id: int, grid, merge: int) -> np.ndarray:
    """[3, S] (temporal, row, column) ids of a prompt with one video span
    (Qwen2-VL): text advances all three together; the video's merged
    patches take their grid coordinates offset by the text before it; text
    after resumes at the largest id + 1."""
    s = len(ids)
    vid = np.flatnonzero(ids == video_token_id)
    if grid is None or len(vid) == 0:
        return np.broadcast_to(np.arange(s), (3, s)).astype(np.int64)
    t, h, w = (int(x) for x in grid)
    gh, gw = h // merge, w // merge
    v0, v1 = int(vid[0]), int(vid[-1]) + 1
    if v1 - v0 != t * gh * gw:
        raise ValueError(f"{v1 - v0} video tokens for a {t}x{gh}x{gw} grid")
    pos = np.zeros((3, s), np.int64)
    pos[:, :v0] = np.arange(v0)
    tt, hh, ww = np.meshgrid(np.arange(t), np.arange(gh), np.arange(gw), indexing="ij")
    pos[:, v0:v1] = np.stack([tt.ravel(), hh.ravel(), ww.ravel()]) + v0
    nxt = int(pos[:, v0:v1].max()) + 1
    pos[:, v1:] = np.arange(nxt, nxt + s - v1)
    return pos


# ---------- rotary ----------


def rope_inv_freq(head_dim: int, theta: float, yarn_factor: Optional[float],
                  original_max: int, beta_fast: float = 32.0, beta_slow: float = 1.0):
    """(inv_freq [head_dim / 2] float64, attention scale): plain RoPE, or
    YaRN's NTK-by-parts blend with its attention scale 0.1 ln(s) + 1."""
    dims = np.arange(0, head_dim, 2, dtype=np.float64) / head_dim
    base = 1.0 / theta ** dims
    if not yarn_factor or yarn_factor <= 1.0:
        return base, 1.0

    def corr(rot):
        return head_dim * math.log(original_max / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(corr(beta_fast)), 0)
    high = min(math.ceil(corr(beta_slow)), head_dim - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(head_dim // 2) - low) / (high - low), 0.0, 1.0)
    extrapolate = 1.0 - ramp
    inv = base / yarn_factor * (1.0 - extrapolate) + base * extrapolate
    return inv, 0.1 * math.log(yarn_factor) + 1.0


class Rotary:
    """cos / sin tables [S, D] (float32, times the attention scale) for
    [3, S] position ids: channel block i of the doubled ``mrope_section``
    list takes its angle from row i % 3; without sections, row 0 alone."""

    def __init__(self, inv_freq: np.ndarray, scale: float, mrope_section, device):
        self.inv = torch.from_numpy(inv_freq).to(device)
        self.scale = scale
        self.section = None if mrope_section is None else list(mrope_section) * 2

    def tables(self, pos: torch.Tensor):
        ang = pos.to(torch.float64)[..., None] * self.inv  # [3, S, D/2]
        if self.section is None:
            half = ang[0]
        else:
            pieces, off = [], 0
            for i, n in enumerate(self.section[: len(self.section) // 2]):
                pieces.append(ang[i % 3, :, off : off + n])
                off += n
            half = torch.cat(pieces, dim=-1)
        emb = torch.cat([half, half], dim=-1)
        return ((torch.cos(emb) * self.scale).to(torch.float32),
                (torch.sin(emb) * self.scale).to(torch.float32))


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [H, S, D] rotated by cos / sin [S, D] (halves rotated)."""
    h = x.shape[-1] // 2
    rot = torch.cat([-x[..., h:], x[..., :h]], dim=-1)
    return x * cos + rot * sin


# ---------- DPSelect and PivotKV ----------


def pivot_scores(q: torch.Tensor, k: torch.Tensor,
                 keypatch: Optional[torch.Tensor]) -> torch.Tensor:
    """PivotKV's scores [V]: each key's attention mass within the chunk
    (softmax rows over the chunk's keys, no causal mask, summed over
    queries, averaged over all query heads), keypatches scored 1.
    q [H, V, D], k [KV, V, D]."""
    h, v, d = q.shape
    kvh = k.shape[0]
    g = h // kvh
    scores = torch.zeros(v, dtype=torch.float32, device=q.device)
    for j in range(kvh):
        logits = q[j * g : (j + 1) * g] @ k[j].T / math.sqrt(d)
        scores += torch.softmax(logits, dim=-1).sum(dim=(0, 1))
    scores /= h
    if keypatch is not None:
        scores = torch.where(keypatch, torch.ones_like(scores), scores)
    return scores


def pivot_keep(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """The ``keep`` best scores, ties to the lower index, in ascending
    index order: int64 [keep]."""
    order = torch.sort(-scores, stable=True).indices
    return torch.sort(order[:keep]).values


def dissimilarity(bank: torch.Tensor) -> torch.Tensor:
    """1 - cos(frame t-1, frame t) per patch position, 1 for the first
    frame: bank [T, N, C] -> [T, N] f32."""
    x = bank.to(torch.float32)
    dis = torch.ones(x.shape[:2], dtype=torch.float32, device=x.device)
    a, b = x[:-1], x[1:]
    cos = (a * b).sum(-1) / (a.norm(dim=-1).clamp_min(1e-8) * b.norm(dim=-1).clamp_min(1e-8))
    dis[1:] = 1.0 - cos
    return dis


def keyframe_peaks(bank: torch.Tensor) -> torch.Tensor:
    """DPSelect's keypatches with every frame kept (compression ratio 1):
    per patch position, the local peaks of the dissimilarity over a window
    of 3 (the left neighbour strictly below, the right one at most equal).
    bank [T, N, C] -> bool [T, N]."""
    dis = dissimilarity(bank)
    peak = torch.ones_like(dis, dtype=torch.bool)
    peak[1:] &= dis[:-1] < dis[1:]
    peak[:-1] &= dis[1:] <= dis[:-1]
    return peak


def reforge_temporal(t: torch.Tensor, keep: int, valid: int) -> torch.Tensor:
    """Kept temporal ids squashed to a contiguous range: min + trunc((t -
    min) * keep / valid), the ratio and product in float32."""
    lo = t.min()
    ratio = torch.tensor(keep, dtype=torch.float32) / torch.tensor(valid, dtype=torch.float32)
    return lo + ((t - lo).to(torch.float32) * ratio.to(t.device)).to(t.dtype)


# ---------- the decoder ----------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


class TextReference:
    """The decoder of a parameter tree (``layers`` stacked [L, ...],
    ``embed_tokens``, ``final_ln``, ``lm_head`` unless tied), each layer's
    weights widened to float32 when it runs."""

    def __init__(self, tree: dict, c: dict, retake: dict, mrope_section, device):
        self.tree, self.c, self.device = tree, c, device
        self.heads, self.kv = c["num_attention_heads"], c["num_key_value_heads"]
        self.hd = c["hidden_size"] // self.heads
        self.eps = c["rms_norm_eps"]
        lv = retake.get("longvideo_kwargs", {})
        self.reforge = bool(lv.get("kvcache_compression")) and bool(
            lv.get("kvcache_compression_kwargs", {}).get("pos_embed_reforge"))
        inv, scale = rope_inv_freq(self.hd, c["rope_theta"], retake.get("scaling_factor"),
                                   c["max_position_embeddings"])
        self.rotary = Rotary(inv, scale, mrope_section, device)

    def _layer(self, i: int) -> dict:
        f = lambda x: x[i].to(self.device, torch.float32)  # noqa: E731
        lp = self.tree["layers"]
        out = {k: f(lp[k]) for k in ("input_ln", "post_ln")}
        for k in ("q", "k", "v", "o", "gate", "up", "down"):
            out[k] = f(lp[k]["w"])
            if "b" in lp[k]:
                out[k + "_b"] = f(lp[k]["b"])
        return out

    def embed(self, ids: np.ndarray) -> torch.Tensor:
        idx = torch.as_tensor(ids, device=self.tree["embed_tokens"].device)
        return self.tree["embed_tokens"][idx].to(self.device, torch.float32)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        x = rms_norm(h, self.tree["final_ln"].to(self.device, torch.float32), self.eps)
        head = self.tree.get("lm_head")
        w = self.tree["embed_tokens"].T if head is None else head
        w = w.to(self.device, torch.float32)
        return torch.cat([x[r : r + 256] @ w for r in range(0, x.shape[0], 256)])

    def run(self, chunks: List[dict]) -> List[torch.Tensor]:
        """Run the chunks in order through every layer. A chunk is a dict
        with ``x`` [n, d] f32 input rows, ``pos`` [3, n] int64 ids,
        ``compress`` / ``keep`` / ``keypatch`` ([n] bool or None) and
        ``append`` (default True; False: the chunk attends to the cache but
        later chunks do not see it). Returns each chunk's last-layer hidden
        rows."""
        xs = [ch["x"] for ch in chunks]
        sizes = [x.shape[0] for x in xs]
        h = torch.cat(xs)
        del xs
        extent, c_len = 0, 0  # the cache buffer must hold the cache and one chunk
        for ch, n in zip(chunks, sizes):
            extent = max(extent, c_len + n)
            if ch.get("append", True):
                c_len += ch["keep"] if ch["compress"] else n
        heads, kv, hd = self.heads, self.kv, self.hd
        g = heads // kv
        for i in range(self.c["num_hidden_layers"]):
            lp = self._layer(i)
            x = rms_norm(h, lp["input_ln"], self.eps)
            q = x @ lp["q"] + lp.get("q_b", 0)
            k = x @ lp["k"] + lp.get("k_b", 0)
            v = x @ lp["v"] + lp.get("v_b", 0)
            del x
            attn = torch.empty_like(q)
            # this layer's cache (rotated keys, values, ids); a chunk's own
            # rows are written past the cache, attended, then the kept ones
            # written back at the cache's end
            ck = torch.empty(kv, extent, hd, dtype=torch.float32, device=self.device)
            cv = torch.empty_like(ck)
            cpos = torch.empty(3, extent, dtype=torch.int64, device=self.device)
            c_len = r0 = 0
            for ch, n in zip(chunks, sizes):
                sl = slice(r0, r0 + n)
                r0 += n
                qc = q[sl].reshape(n, heads, hd).transpose(0, 1)
                kc = k[sl].reshape(n, kv, hd).transpose(0, 1)
                vc = v[sl].reshape(n, kv, hd).transpose(0, 1)
                pos = ch["pos"].to(self.device).clone()
                if self.reforge:  # continue the layer's cached temporal ids
                    prev = int(cpos[0, c_len - 1]) if c_len else -1
                    pos[0] += prev + 1 - pos[0, 0]
                cos, sin = self.rotary.tables(pos)
                qr, kr = rotate(qc, cos, sin), rotate(kc, cos, sin)
                end = c_len + n
                ck[:, c_len:end], cv[:, c_len:end] = kr, vc
                causal = torch.ones(n, n, dtype=torch.bool, device=self.device).tril()
                out = torch.empty(heads, n, hd, dtype=torch.float32, device=self.device)
                for hh in range(heads):
                    j = hh // g
                    logit = qr[hh] @ ck[j, :end].T / math.sqrt(hd)
                    logit[:, c_len:].masked_fill_(~causal, -math.inf)
                    out[hh] = torch.softmax(logit, dim=-1) @ cv[j, :end]
                    del logit
                attn[sl] = out.transpose(0, 1).reshape(n, heads * hd)
                if not ch.get("append", True):
                    continue  # attends to the cache, joins it not
                keep = n
                if ch["compress"]:
                    qs, ks = (qc, kc) if self.reforge else (qr, kr)
                    kept = pivot_keep(pivot_scores(qs, ks, ch.get("keypatch")), ch["keep"])
                    keep = len(kept)
                    pos = pos[:, kept]
                    if self.reforge:
                        pos[0] = reforge_temporal(pos[0], keep, n)
                        c2, s2 = self.rotary.tables(pos)
                        kr = rotate(kc[:, kept], c2, s2)
                    else:
                        kr = kr[:, kept]
                    ck[:, c_len : c_len + keep] = kr
                    cv[:, c_len : c_len + keep] = vc[:, kept]
                cpos[:, c_len : c_len + keep] = pos
                c_len += keep
            del q, k, v, ck, cv, cpos
            h = h + attn @ lp["o"] + lp.get("o_b", 0)
            del attn
            for r in range(0, h.shape[0], MLP_ROWS):
                x = rms_norm(h[r : r + MLP_ROWS], lp["post_ln"], self.eps)
                gate = x @ lp["gate"]
                up = x @ lp["up"]
                h[r : r + MLP_ROWS] += (torch.nn.functional.silu(gate) * up) @ lp["down"]
                del x, gate, up
            del lp
        return list(torch.split(h, sizes))


def served_logits(text: TextReference, chunks: List[dict], decode_pos_base: int,
                  streams: List[np.ndarray]) -> List[torch.Tensor]:
    """Run the prompt's chunks, then each stream of served tokens after its
    first as one more chunk that sees the prompt's cache (and not the other
    streams). Returns, for each stream, the reference's logits [n, V] f32
    at the positions of its n tokens: row 0 after the prompt, row i after
    the stream's first i tokens."""
    chunks = list(chunks)
    n_prompt = len(chunks)
    streams = [np.asarray(t, dtype=np.int64) for t in streams]
    for toks in streams:
        n = len(toks) - 1
        if n > 0:
            pos = torch.from_numpy(np.broadcast_to(decode_pos_base + np.arange(n), (3, n)).copy())
            chunks.append(dict(x=text.embed(toks[:-1]), pos=pos, compress=False, append=False))
    outs = text.run(chunks)
    first = text.logits(outs[n_prompt - 1][-1:])
    result, j = [], n_prompt
    for toks in streams:
        if len(toks) > 1:
            result.append(torch.cat([first, text.logits(outs[j])]))
            j += 1
        else:
            result.append(first)
    return result


def prompt_chunks(text: TextReference, ids: np.ndarray, pos: np.ndarray, video: torch.Tensor,
                  keypatch: np.ndarray, video_token_id: int, chunk_tokens: int,
                  retake: dict) -> List[dict]:
    """The prompt as plan chunks: text rows embedded, the video span's rows
    taken from ``video`` [n_video, d] f32, keypatch flags of the video span
    (``keypatch`` [n_video] bool)."""
    steps = plan(ids, video_token_id, chunk_tokens, compression_ratio(retake, len(ids)))
    vid = np.flatnonzero(ids == video_token_id)
    v0 = int(vid[0]) if len(vid) else -1
    chunks = []
    for st in steps:
        s, n = st["start"], st["valid"]
        if v0 >= 0 and ids[s] == video_token_id:
            x = video[s - v0 : s - v0 + n]
            kp = torch.as_tensor(keypatch[s - v0 : s - v0 + n], device=text.device)
        else:
            x, kp = text.embed(ids[s : s + n]), None
        chunks.append(dict(x=x, pos=torch.from_numpy(pos[:, s : s + n].copy()),
                           compress=st["compress"], keep=st["keep"], keypatch=kp))
    return chunks
