"""Rows 10-13 together, the int8 blocks' four dispatches (the MLP half, the
qkv projection with LayerNorm, the out projection with gate and residual,
the adaLN projection): the sum of their least times over the sum of their
profiled device times. They share kernel names (the modulate pass and the
int8 GEMM serve rows 10-12), so no split by row is possible."""

from benchmarks.harness.roofline import bound_s, int8_block, model_dims
from benchmarks.harness.trace import kernel_seconds

KERNELS = ("adaln_mlp_modulate_kernel", "adaln_mlp_gemm_kernel", "int8_matmul_skinny_kernel",
           "adaln_mlp_cast_kernel")


def read(record):
    tr = record.get("trace")
    if (record.get("kind") != "sample" or not tr or not record.get("traced")
            or not record["traffic"]["quantize_weights"]):
        return None
    seconds, count = kernel_seconds(tr, KERNELS)
    if count == 0:
        return None
    cfg, traffic = record["config"], record["traffic"]
    d, depth, _, _, hdim = model_dims(cfg)
    least = sum(sum(bound_s(*part) for part in int8_block(r["batch"], r["t_pad"], d, hdim))
                * depth * traffic["steps"] for r in record["traced"])
    return 100 * least / seconds
