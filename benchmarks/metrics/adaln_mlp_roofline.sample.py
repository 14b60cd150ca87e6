"""Row 7, kernel B in the f32 sampling chains (its modulate pass and its
two GEMMs): its least time over its profiled device time. Each launch
reads x (f32), the three modulation vectors, both weights (bf16) and their
biases, and writes out (f32), at the bucket's padded length."""

from benchmarks.harness.roofline import BF16, F32, bound_s, mlp_fwd, model_dims
from benchmarks.harness.trace import kernel_seconds

KERNELS = ("adaln_mlp_modulate_kernel", "adaln_mlp_gemm_kernel")


def read(record):
    tr = record.get("trace")
    if (record.get("kind") != "sample" or not tr or not record.get("traced")
            or record["traffic"]["quantize_weights"]):
        return None
    seconds, count = kernel_seconds(tr, KERNELS)
    if count == 0:
        return None
    cfg, traffic = record["config"], record["traffic"]
    d, depth, _, _, hdim = model_dims(cfg)
    least = sum(bound_s(*mlp_fwd(r["batch"], r["t_pad"], d, hdim, F32, BF16, False))
                * depth * traffic["steps"] for r in record["traced"])
    return 100 * least / seconds
