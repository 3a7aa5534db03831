"""retake_tpu_torch: the PyTorch/CUDA port of retake-tpu for one NVIDIA H100.

The JAX package ``retake_tpu`` is the reference this package is held against;
each module here keeps the module path of its JAX counterpart
(``ops/rope.py`` <-> ``ops/rope.py`` and so on). This package imports
``torch`` and never ``jax``.

Package map:
  models/qwen2_vl/  config dataclasses, weights (random init, JAX bridge),
                    ``VisionTower`` / ``TextDecoder`` / ``Qwen2VLModel``
  ops/              M-RoPE/YaRN, attention, PivotKV, DPSelect (plain torch)
  ops/cuda/         wrappers of the hand-written Hopper kernels (K1 prefill
                    attention, K2 PivotKV scores, K3 ViT attention), their
                    plain twins and the nvcc build
  csrc/             the CUDA C++ sources (sm_90a)
  runtime/          static KV cache and the chunked-prefill engine
  utils/            config surface, host positions, stage timing
"""

__version__ = "0.1.0"
