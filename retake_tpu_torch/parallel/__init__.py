"""Tensor parallelism for the port (``mesh.py``)."""

from retake_tpu_torch.parallel.mesh import (
    Mesh,
    ReplicaDivergence,
    TensorParallel,
    kv_slice,
    make_mesh,
    shard_params,
    spec_for_path,
)

__all__ = ["Mesh", "ReplicaDivergence", "TensorParallel", "kv_slice", "make_mesh",
           "shard_params", "spec_for_path"]
