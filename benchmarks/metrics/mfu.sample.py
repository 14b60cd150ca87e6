"""The model's share of the card's bf16 peak over the window: the forward's
operations at each completed map's real length and the batch its chain
dispatched (benchmarks/harness/roofline.py: the tokens' products, adaLN
once a sample, the banded pairs, the embedders and head), times its
denoise steps, over the window's seconds and 989 TFLOP/s."""

from benchmarks.harness.roofline import BF16_FLOPS, forward_flops, pair_count


def read(record):
    reqs = record.get("requests") if record.get("kind") == "sample" else None
    if not reqs:
        return None
    cfg, tr = record["config"], record["traffic"]
    flops = sum(forward_flops(cfg, r["batch"], r["length"], pair_count(r["length"], tr["band"], r["length"]))
                for r in reqs) * tr["steps"]
    return 100 * flops / record["window_s"] / BF16_FLOPS
