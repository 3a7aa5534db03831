"""retake_tpu_torch: the PyTorch/CUDA port of retake-tpu for one NVIDIA H100.

The JAX package ``retake_tpu`` is the reference this package is held against;
each module here keeps the module path of its JAX counterpart
(``ops/rope.py`` <-> ``ops/rope.py`` and so on). This package imports
``torch`` and never ``jax``.

Package map:
  device.py         the device a caller names (no silent CPU fallback)
  models/qwen2_vl/  config dataclasses, weights (random init, int8 on the
                    device, JAX bridge), ``VisionTower`` / ``TextDecoder`` /
                    ``Qwen2VLModel``
  ops/              M-RoPE/YaRN, attention, PivotKV, DPSelect (plain torch);
                    ``quantization.py``: int8 quantizers, weight-only and
                    W8A8 linears
  ops/cuda/         wrappers of the hand-written Hopper kernels (K1 prefill
                    attention and its int8-KV mode, K2 PivotKV score sums:
                    row statistics, column sums and a fixed-order merge, K3
                    ViT attention, K4 gap-layout batched decode and its
                    int8-KV mode), their plain twins and the nvcc build
  csrc/             the CUDA C++ sources (sm_90a)
  runtime/          static KV cache (bf16 or int8), the chunked-prefill
                    engine, ``serve.py``: the continuous-batching server
  utils/            config surface, host positions, stage timing
"""

__version__ = "0.1.0"
