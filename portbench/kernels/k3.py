"""K3: ViT attention within each slice with the 2-D rotary fused
(``vit_attention_qkv``)."""

from portbench import counts

ENTRY = ("retake_tpu_torch.ops.cuda.vit_attention", "vit_attention_qkv")
DEVICE_NAMES = ("vit_attention_kernel",)


def record(qkv, cos, sin) -> dict:
    t, s, n, _, d = qkv.shape
    return dict(t=t, s=s, n=n, d=d)


def count(c: dict) -> dict:
    return counts.k3_vit(c["t"], c["s"], c["n"], c["d"])
