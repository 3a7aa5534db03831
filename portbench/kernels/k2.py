"""K2: PivotKV column sums of the chunk's softmax (``pivot_score_sums``):
row statistics, column sums and a head-order merge."""

from portbench import counts, program

ENTRY = ("retake_tpu_torch.ops.cuda.pivot_scores", "pivot_score_sums")
DEVICE_NAMES = ("row_stats_kernel", "col_sums_kernel", "::merge_kernel")


def record(q, k, valid_len) -> dict:
    return dict(heads=q.shape[0], kv=k.shape[0], d=q.shape[2],
                valid=program.device_scalar(valid_len))


def count(c: dict) -> dict:
    return counts.k2_scores(c["heads"], c["kv"], c["d"], c["valid"])
