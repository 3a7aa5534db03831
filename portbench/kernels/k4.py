"""K4: the batched gap-layout decode flash state
(``decode_gapped_flash_state``), bf16 or int8 K/V."""

from portbench import counts, program

ENTRY = ("retake_tpu_torch.ops.cuda.decode_gapped", "decode_gapped_flash_state")
DEVICE_NAMES = ("decode_gapped_kernel",)


def record(q, kc, vc, final_len, dec_start, write_end, k_scale=None, v_scale=None) -> dict:
    return dict(kv=q.shape[1], group=q.shape[2], d=q.shape[3],
                final_len=final_len.detach().clone(), dec_start=dec_start.detach().clone(),
                write_end=program.host_int(write_end), int8_kv=k_scale is not None)


def count(c: dict) -> dict:
    return counts.k4_decode(c["kv"], c["group"], c["d"],
                            counts.k4_live_columns(c["final_len"], c["dec_start"], c["write_end"]),
                            c["int8_kv"])
