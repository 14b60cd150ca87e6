"""Rows 2, 3 and 4 together, the banded attention's forward with LSE and its
dq and dk/dv kernels at the training shape (bf16 q, k, v, o, do; band =
the window, so every pair): the sum of their least times over their
profiled device time. Remat runs the forward twice a step."""

from benchmarks.harness.roofline import BF16, attn_bwd, attn_fwd, bound_s, model_dims
from benchmarks.harness.trace import kernel_seconds

KERNELS = ("banded_attn_fwd_sm90_kernel", "banded_attn_bwd_dq_sm90_kernel", "banded_attn_bwd_dkv_sm90_kernel")


def read(record):
    tr = record.get("trace")
    if record.get("kind") != "train" or not tr or not record.get("traced_steps"):
        return None
    seconds, count = kernel_seconds(tr, KERNELS)
    if count == 0:
        return None
    _, depth, heads, dh, _ = model_dims(record["config"])
    t = record["traffic"]
    n, s = t["batch"], t["seq_len"]
    fwd = bound_s(*attn_fwd(n, heads, s, dh, s, s, BF16, BF16, True)) * (2 if t["remat"] else 1)
    bwd = sum(bound_s(*part) for part in attn_bwd(n, heads, s, dh, s, s, BF16))
    return 100 * (fwd + bwd) * depth * record["traced_steps"] / seconds
