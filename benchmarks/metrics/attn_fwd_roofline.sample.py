"""Row 1, the banded attention forward of the sampling chains: its least
time over its profiled device time. Each launch reads q, k, v (f32) and
writes o (f32; bf16 in the int8 blocks) at the bucket's padded length,
and computes the pairs of its band below the map's length; a chain
launches it once a block a step."""

from benchmarks.harness.roofline import attn_fwd, bound_s, model_dims
from benchmarks.harness.trace import kernel_seconds

KERNELS = ("banded_attn_fwd_sm90_kernel",)


def read(record):
    tr = record.get("trace")
    if record.get("kind") != "sample" or not tr or not record.get("traced"):
        return None
    seconds, count = kernel_seconds(tr, KERNELS)
    if count == 0:
        return None
    cfg, traffic = record["config"], record["traffic"]
    d, depth, heads, dh, _ = model_dims(cfg)
    o_io = 2 if traffic["quantize_weights"] else 4
    least = sum(bound_s(*attn_fwd(r["batch"], heads, r["t_pad"], dh, traffic["band"],
                                  r["length"], 4, o_io, False)) * depth * traffic["steps"]
                for r in record["traced"])
    return 100 * least / seconds
