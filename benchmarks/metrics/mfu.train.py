"""The train step's share of the card's bf16 peak over the window: three
times the forward's operations at the batch (remat's recompute not
counted; adaLN once a sample), times the window's optimizer steps, over
its seconds and 989 TFLOP/s."""

from benchmarks.harness.roofline import BF16_FLOPS, train_step_flops


def read(record):
    if record.get("kind") != "train" or not record["steps"]:
        return None
    tr = record["traffic"]
    flops = train_step_flops(record["config"], tr["batch"], tr["seq_len"], tr["seq_len"])
    return 100 * flops * record["steps"] / record["window_s"] / BF16_FLOPS
