"""Row 8, kernel B's training forward (with the residuals a and mlp) at the
training shape, bf16 stream and weights: its least time over its profiled
device time. Remat runs it twice a step."""

from benchmarks.harness.roofline import BF16, bound_s, mlp_fwd, model_dims
from benchmarks.harness.trace import kernel_seconds

KERNELS = ("adaln_mlp_modulate_kernel", "adaln_mlp_gemm_kernel")


def read(record):
    tr = record.get("trace")
    if record.get("kind") != "train" or not tr or not record.get("traced_steps"):
        return None
    seconds, count = kernel_seconds(tr, KERNELS)
    if count == 0:
        return None
    d, depth, _, _, hdim = model_dims(record["config"])
    t = record["traffic"]
    launches = depth * (2 if t["remat"] else 1) * record["traced_steps"]
    return 100 * bound_s(*mlp_fwd(t["batch"], t["seq_len"], d, hdim, BF16, BF16, True)) * launches / seconds
