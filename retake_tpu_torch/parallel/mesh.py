"""Tensor parallelism: one process per rank, explicit collectives (port of
``retake_tpu/parallel/mesh.py`` and the ``cache_sharding=`` paths of the
JAX engines).

The JAX package is one controller: GSPMD spreads one parameter tree over a
``(dp, tp)`` device mesh and inserts the all-reduces. Here every rank is a
process that holds its own slice of the tree and calls the collectives
itself, through a ``TensorParallel`` handle:

* **The rules are the JAX rules, leaf for leaf** (``spec_for_path``, a
  copy of the JAX ``_spec_for_path``): q / k / v / gate / up shard their
  output columns (bias and int8 scale with them), o / down their input
  rows (a row-parallel output's bias and scale stay whole), an untied
  ``lm_head`` its vocabulary; the embedding, the norms and the vision
  towers are replicated. ``shard_params`` slices the port's tree (the JAX
  layout: ``[L, in, out]``, int8 ``{'w', 'scale'}``) down to the rank's
  share, as contiguous copies; the models lay int8 weights out
  column-major after the slice (``ops/quantization.col_major_int8``).
* **The KV cache** holds the rank's ``KV / tp`` heads (``kv_slice``);
  ``kv_heads % tp != 0`` raises (the JAX module bounds ``tp <= kv heads``).
* **Collectives in the decoder** (``models/qwen2_vl/text.py``): two
  all-reduces per layer, after the row-parallel o and down (W8A8 also
  all-reduces the activation row's absmax first and then sums the int32
  accumulators, so it is bit-identical to one device); one all-reduce of
  PivotKV's ``[S]`` head sum per layer of a compressing chunk, so every
  rank ranks the same scores; one all-gather of the vocabulary-parallel
  logits.
* **The vision towers shard frames** (``_vit_chunk_tp`` /
  ``_siglip_chunk_tp`` in JAX): a chunk whose frame count divides ``tp``
  runs ``frames / tp`` frames on each rank, and the outputs are
  all-gathered in frame order; any other chunk runs whole on every rank.

Everything else (DPSelect, the embed scatter, the chunk plan, the sampler,
EOS checks) runs replicated and must compute the same bits on every rank:
``TensorParallel.check`` turns on a digest of those values that the
engines compare across ranks at the end of each request
(``assert_replicated``). The continuous server's wall-clock decisions are
taken by rank 0 and broadcast (``broadcast_ints``); in online mode rank 0
also sends each request it admits (``broadcast_tensor`` /
``broadcast_bytes``: a header of ints, then the payload) to the other
ranks (``runtime/serve.py``).

The handle calls the group object's own methods
(``group.allreduce([t], opts).wait()``), so it takes a group from
``torch.distributed.new_group`` (``make_mesh``) or one built directly, e.g.
two ``ProcessGroupGloo`` over one store on two threads (the CPU tests).
``"gloo"`` carries CPU and CUDA tensors (staged through host memory, so
ranks may share a card); ``"nccl"`` needs CUDA tensors and one card per
rank; any other backend raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np
import torch

BACKENDS = ("gloo", "nccl")
MAX_DIMS = 8  # broadcast_tensor's header holds this many dims
# the dtypes broadcast_tensor carries (its header's code is the index here)
BROADCAST_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int64,
           torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)

# column-parallel linears (output dim sharded); row-parallel (input sharded)
_COL_PARALLEL = ("q", "k", "v", "gate", "up")
_ROW_PARALLEL = ("o", "down")


def spec_for_path(names) -> tuple:
    """The TP rule for the leaf at key path ``names``: a partition spec as a
    tuple (``None`` or ``"tp"`` per leading dim; ``()`` replicated), the
    JAX ``_spec_for_path`` case for case."""
    names = list(names)
    if "layers" in names and len(names) >= 2:
        parent, leaf_name = names[-2], names[-1]
        if parent in _COL_PARALLEL:
            if leaf_name == "w":
                return (None, None, "tp")
            if leaf_name in ("b", "scale"):
                return (None, "tp")
        if parent in _ROW_PARALLEL:
            if leaf_name == "w":
                return (None, "tp", None)
            return ()  # row-parallel outputs replicate bias/scale
    if names and names[0] == "lm_head":
        if names[-1] == "scale":
            return ("tp",)
        return (None, "tp")
    if names == ["lm_head"]:
        return (None, "tp")
    return ()  # embeddings, norms, vision tower: replicated


class ReplicaDivergence(RuntimeError):
    """Values every rank computes replicated differ between ranks."""


class TensorParallel:
    """The ``tp`` process group of one rank and its collectives.

    ``seconds`` / ``calls`` add up the wall time spent in the handle's
    collectives; with ``timed`` the device is synchronized before and after
    each one, so the time is the collective's own and not the work queued
    before it (gloo waits for that work). ``check``: the engines digest the
    values they compute replicated and compare the digests across ranks at
    the end of each request."""

    def __init__(self, group, backend: Optional[str] = None):
        self.group = group
        self.rank = group.rank()
        self.size = group.size()
        self.backend = backend or group.name()
        if self.backend not in BACKENDS:
            raise ValueError(f"tensor parallelism supports {BACKENDS}, got {self.backend!r}")
        self.timed = False
        self.check = False
        self.seconds = 0.0
        self.calls = 0
        self.bytes_broadcast = 0  # payload bytes of broadcast_tensor / broadcast_bytes
        self._digest = hashlib.sha256()

    def __repr__(self) -> str:
        return f"TensorParallel(rank={self.rank}, size={self.size}, backend={self.backend!r})"

    def bind(self, device) -> None:
        """Raise unless this group can carry tensors on ``device``: NCCL
        needs CUDA and every rank on a card of its own (checked across the
        group), gloo takes the CPU and CUDA alike."""
        device = torch.device(device)
        if self.backend == "nccl":
            if device.type != "cuda":
                raise ValueError(f"an NCCL group cannot carry tensors on {device}")
            index = torch.cuda.current_device() if device.index is None else device.index
            cards = self.all_gather(torch.tensor([index], dtype=torch.int64, device=device))
            if len(set(cards.tolist())) != self.size:
                raise ValueError(f"NCCL ranks share a card ({cards.tolist()}); use gloo")

    def _run(self, work_fn, t: torch.Tensor):
        sync = self.timed and t.is_cuda
        if sync:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        self.calls += 1  # issued: counted even if it raises
        work_fn().wait()
        if sync:
            torch.cuda.synchronize(t.device)
        self.seconds += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or max) ``t`` over the group in place; returns ``t``."""
        import torch.distributed as dist

        opts = dist.AllreduceOptions()
        opts.reduceOp = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if not t.is_contiguous():
            raise ValueError("all_reduce needs a contiguous tensor")
        self._run(lambda: self.group.allreduce([t], opts), t)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order."""
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(self.size)]
        self._run(lambda: self.group.allgather([outs], [t]), t)
        return torch.cat(outs, dim=dim)

    def _host_device(self):
        """Where small host messages travel: the CPU, or the card under NCCL."""
        return torch.device("cuda", torch.cuda.current_device()) if self.backend == "nccl" else "cpu"

    def broadcast_ints(self, values) -> list:
        """Rank 0's ``values`` (a few ints) on every rank."""
        t = torch.tensor(list(values), dtype=torch.int64, device=self._host_device())
        self._broadcast(t)
        return t.tolist()

    def agree(self, flag: int) -> list:
        """Every rank's ``flag`` (an int), in rank order. An all-to-all, a
        collective the engines never issue: paired by mistake with one of
        theirs (a rank that went its own way) it times out, where one of
        the same kind and another size would abort a gloo process."""
        import torch.distributed as dist

        t = torch.full((self.size,), int(flag), dtype=torch.int64, device=self._host_device())
        out = torch.empty_like(t)
        self._run(lambda: self.group.alltoall_base(out, t, [], [], dist.AllToAllOptions()), t)
        return out.tolist()

    def broadcast_tensor(self, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Rank 0's tensor ``t`` (any dtype, up to ``MAX_DIMS`` dims; the
        other ranks pass nothing) on every rank, on ``_host_device()``: a
        header of ints (dtype, shape), then the payload as bytes."""
        head = [0] * (2 + MAX_DIMS)
        if self.rank == 0:
            if t.dim() > MAX_DIMS:
                raise ValueError(f"broadcast_tensor takes up to {MAX_DIMS} dims, got {t.dim()}")
            head[:2 + t.dim()] = [BROADCAST_DTYPES.index(t.dtype), t.dim(), *t.shape]
        head = self.broadcast_ints(head)
        dtype, shape = BROADCAST_DTYPES[head[0]], head[2:2 + head[1]]
        if self.rank == 0:
            data = t.detach().to(self._host_device()).contiguous().reshape(-1).view(torch.uint8)
        else:
            n = int(np.prod(shape, dtype=np.int64)) * torch.empty(0, dtype=dtype).element_size()
            data = torch.empty(n, dtype=torch.uint8, device=self._host_device())
        if data.numel():
            self._broadcast(data)
        self.bytes_broadcast += data.numel()
        return data.view(dtype).reshape(shape)

    def broadcast_bytes(self, b: Optional[bytes] = None) -> bytes:
        """Rank 0's ``b`` (the other ranks pass nothing) on every rank."""
        t = None if self.rank else torch.frombuffer(bytearray(b), dtype=torch.uint8)
        return self.broadcast_tensor(t).cpu().numpy().tobytes()

    def _broadcast(self, t: torch.Tensor) -> None:
        import torch.distributed as dist

        opts = dist.BroadcastOptions()
        opts.rootRank = 0
        self._run(lambda: self.group.broadcast([t], opts), t)

    # ---------- replica checks ----------

    def note(self, *values) -> None:
        """Add values computed replicated to the running digest (only
        under ``check``; each value is read back to the host)."""
        if self.check:
            for v in values:
                self._digest.update(_bytes_of(v))

    def assert_replicated(self, label: str, *values) -> None:
        """Under ``check``: compare the running digest (plus ``values``)
        across the group, raise ``ReplicaDivergence`` if any rank differs,
        and start a new digest."""
        if not self.check:
            return
        self.note(*values)
        word = np.frombuffer(self._digest.digest()[:16], dtype=np.int64).copy()
        self._digest = hashlib.sha256()
        got = self.all_gather(torch.from_numpy(word).to(self._host_device()))
        got = got.reshape(self.size, -1).cpu()
        if not bool((got == got[0]).all()):
            raise ReplicaDivergence(f"{label}: replicated values differ across the "
                                    f"{self.size} ranks (digests {got.tolist()})")


def _bytes_of(v) -> bytes:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.view(torch.int16)
        return v.contiguous().numpy().tobytes() + str(tuple(v.shape)).encode()
    a = np.ascontiguousarray(np.asarray(v))
    return a.tobytes() + str(a.shape).encode()


@dataclasses.dataclass
class Mesh:
    """One rank's place in a ``dp x tp`` layout: ``dp_rank`` of ``dp``
    replicas, ``tp`` its handle (None at tp = 1)."""

    dp: int
    dp_rank: int
    tp: Optional[TensorParallel]


def make_mesh(dp: int, tp: int, backend: str) -> Mesh:
    """Lay out the ``dp * tp`` ranks of the initialised default process
    group: the ``tp`` groups are consecutive ranks (replica ``rank // tp``).
    Every rank calls this, in the same order, since each group is created
    collectively. ``backend`` is explicit: ``"gloo"`` allows ranks on one
    card, ``"nccl"`` needs a card per rank (``TensorParallel.bind``)."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"tensor parallelism supports {BACKENDS}, got {backend!r}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * tp != world:
        raise ValueError(f"dp {dp} x tp {tp} != world size {world}")
    mine = None
    for replica in range(dp):
        ranks = list(range(replica * tp, (replica + 1) * tp))
        group = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            mine = group
    handle = TensorParallel(mine, backend) if tp > 1 else None
    return Mesh(dp=dp, dp_rank=rank // tp, tp=handle)


def kv_slice(num_kv_heads: int, tp: Optional[TensorParallel]) -> slice:
    """The KV heads of the global cache that ``tp``'s rank holds."""
    if tp is None:
        return slice(0, num_kv_heads)
    if num_kv_heads % tp.size:
        raise ValueError(f"{num_kv_heads} KV heads do not split over tp = {tp.size}")
    n = num_kv_heads // tp.size
    return slice(tp.rank * n, (tp.rank + 1) * n)


def shard_leaf(x: torch.Tensor, spec: tuple, tp: TensorParallel) -> torch.Tensor:
    """The rank's share of one leaf under ``spec``: a contiguous copy, so
    the whole leaf can be freed; a replicated leaf is returned as it is."""
    if "tp" not in spec:
        return x
    dim = spec.index("tp")
    n = x.shape[dim]
    if n % tp.size:
        raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf does not split over "
                         f"tp = {tp.size}")
    part = n // tp.size
    return x.narrow(dim, tp.rank * part, part).clone(memory_format=torch.contiguous_format)


def shard_params(params: dict, tp: Optional[TensorParallel], _names=()) -> dict:
    """The rank's slice of a parameter tree (Qwen2-VL or LLaVA, bf16 or
    int8) under the JAX rules; ``tp=None`` returns the tree as it is."""
    if tp is None:
        return params
    out = {}
    for k, v in params.items():
        names = _names + (k,)
        out[k] = (shard_params(v, tp, names) if isinstance(v, dict)
                  else shard_leaf(v, spec_for_path(names), tp))
    return out
