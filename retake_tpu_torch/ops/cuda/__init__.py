"""Wrappers of the hand-written Hopper kernels (sources in ``csrc/``).

Each module holds one kernel's wrapper, its plain PyTorch twin and a launch
counter (``<wrapper>.launches``, incremented once per kernel launch). A
wrapper sends a CPU tensor to the plain twin; on a CUDA tensor it launches
the kernel or raises — it never falls back.

  flash_prefill.flash_prefill_attention  K1 <- ops/pallas/flash_prefill.py
  flash_prefill.flash_prefill_attention_int8
                                         K1, int8-KV mode
  pivot_scores.pivot_score_sums          K2 <- ops/pallas/pivot_scores.py
  vit_attention.vit_attention_qkv        K3 <- ops/pallas/vit_attention.py
  decode_gapped.decode_gapped_flash_state
                                         K4 <- ops/pallas/decode_gapped.py
  decode_gapped.decode_gapped_flash_state_int8
                                         K4, int8-KV mode

A kernel with two modes has one counter per mode; its bf16 wrapper sends
int8 inputs (with their scales) to the int8 one.
"""
