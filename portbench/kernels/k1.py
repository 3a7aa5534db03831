"""K1: chunk-prefill GQA attention over [cache | chunk]
(``flash_prefill_attention``), bf16 or int8 K/V with per-key scales."""

from portbench import counts, program

ENTRY = ("retake_tpu_torch.ops.cuda.flash_prefill", "flash_prefill_attention")
DEVICE_NAMES = ("flash_prefill_kernel",)


def record(q, kc, vc, cache_len, kn, vn, valid_len, k_scale=None, *a, **kw) -> dict:
    return dict(heads=q.shape[0], kv=kc.shape[0], d=q.shape[2],
                cache_len=program.device_scalar(cache_len),
                valid=program.device_scalar(valid_len), int8_kv=k_scale is not None)


def count(c: dict) -> dict:
    return counts.k1_prefill(c["heads"], c["kv"], c["d"], c["cache_len"], c["valid"],
                             c["int8_kv"])
