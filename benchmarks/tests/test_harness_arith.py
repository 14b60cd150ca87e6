"""The yardstick's arithmetic: the FLOP count against a hand count, the
banded pair count against the mask, and the kernels' bounds against the
kernel table's rows."""
import json
import os

import pytest
import torch

from benchmarks.harness import roofline as rl

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config(name):
    with open(os.path.join(ROOT, "benchmarks", "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,d,depth,heads", [("dit-b", 768, 12, 12), ("dit-xl", 1152, 28, 16)])
def test_forward_flops_by_hand(name, d, depth, heads):
    cfg = config(name)
    n, t, band = 2, 300, 128
    pairs = sum(min(t - 1, q + band) - max(0, q - band + 1) + 1 for q in range(t))
    hand = depth * (2 * n * t * 12 * d * d + 2 * n * 6 * d * d + 4 * d * n * pairs)
    hand += 2 * n * t * (2 * 128 + 128 + 144) * d + 2 * n * (256 * d + d * d)
    hand += 2 * n * 2 * d * d + 2 * n * t * d * 4
    assert rl.forward_flops(cfg, n, t, pairs) == hand


def test_adaln_counted_once_a_sample():
    cfg = config("dit-xl")
    d, depth = 1152, 28
    one, two = (rl.forward_flops(cfg, 1, t, 0) for t in (1, 2))
    token = two - one  # a token's share: everything but the per-sample parts
    assert token == 2 * (12 * d * d * depth + (2 * 128 + 128 + 144) * d + d * 4)
    assert one - token == 2 * (6 * d * d * depth + 256 * d + d * d + 2 * d * d)


def test_xl_train_step_flops():
    # 3 x the forward at batch 256 x 128, every pair of the 128-wide band
    flops = rl.train_step_flops(config("dit-xl"), 256, 128, 128)
    assert 89.6e12 < flops < 89.9e12
    # the 6 P tokens count, adaLN at every token, is ~1.49x this
    p_block = 12 * 1152 ** 2 + 6 * 1152 ** 2
    assert 1.45 < 6 * p_block * 28 * 256 * 128 / (flops - 3 * 4 * 1152 * 256 * 128 * 128 * 28) < 1.55


@pytest.mark.parametrize("t,band,valid,query_valid", [
    (128, 128, 128, False), (768, 128, 757, False), (768, 128, 757, True), (200, 20, 190, True),
    (2048, 128, 2000, False), (64, 16, 30, False)])
def test_pair_count_against_mask(t, band, valid, query_valid):
    q = torch.arange(t)[:, None]
    k = torch.arange(t)[None, :]
    allowed = (k > q - band) & (k <= q + band) & (k < valid)
    if query_valid:
        allowed &= q < valid
    assert rl.pair_count(t, band, valid, query_valid) == int(allowed.sum())


@pytest.mark.parametrize("row,got,table_ms", [
    ("1", lambda: rl.attn_fwd(2, 12, 768, 64, 128, 757, 4, 4, False), 0.0056),
    ("7", lambda: rl.mlp_fwd(2, 768, 768, 3072, 4, 2, False), 0.0147),
    ("2", lambda: rl.attn_fwd(256, 12, 128, 64, 128, 128, 2, 2, True), 0.0606),
    ("3", lambda: rl.attn_bwd(256, 12, 128, 64, 128, 128, 2)[0], 0.0906),
    ("4", lambda: rl.attn_bwd(256, 12, 128, 64, 128, 128, 2)[1], 0.1056),
    ("8", lambda: rl.mlp_fwd(256, 128, 768, 3072, 2, 2, True), 0.3127),
    ("8 XL", lambda: rl.mlp_fwd(256, 128, 1152, 4608, 2, 2, True), 0.7035),
    ("13", lambda: rl.int8_block(2, 768, 768, 3072)[0], 0.0011),
    ("11", lambda: rl.int8_block(2, 768, 768, 3072)[1], 0.0062),
    ("12", lambda: rl.int8_block(2, 768, 768, 3072)[2], 0.0037),
    ("10", lambda: rl.int8_block(2, 768, 768, 3072)[3], 0.0147),
])
def test_bounds_match_the_kernel_table(row, got, table_ms):
    assert round(rl.bound_s(*got()) * 1e3, 4) == table_ms


def test_bound_takes_the_larger_side():
    assert rl.bound_s(rl.HBM_BPS, 0) == 1.0
    assert rl.bound_s(0, rl.BF16_FLOPS * 2) == 2.0


@pytest.mark.parametrize("name", ["mfu.sample", "attn_fwd_roofline.sample", "adaln_mlp_roofline.sample",
                                  "int8_gemm_roofline.sample"])
def test_sample_readers_count_the_batch_each_chain_dispatched(name):
    from benchmarks.harness.cell import load_module
    from benchmarks.harness.trace import kernel_seconds

    reader = load_module(os.path.join(ROOT, "benchmarks", "metrics", name + ".py"), "reader_" + name)
    kernels = getattr(reader, "KERNELS", ())
    trace = {"kernels": {k: {"s": 1.0, "count": 1} for k in kernels}, "busy_s": 1.0, "window_s": 1.0}
    assert kernels == () or kernel_seconds(trace, kernels)[1] == len(kernels)
    with open(os.path.join(ROOT, "benchmarks", "traffic", "sample-f32.json")) as f:
        mix = json.load(f)
    mix["quantize_weights"] = name.startswith("int8")

    def record(batch):
        reqs = [{"length": 757, "t_pad": 768, "batch": batch, "host_s": 0.1, "chain_s": 1.0}]
        return {"kind": "sample", "config": config("dit-b"), "traffic": mix, "window_s": 2.0,
                "requests": reqs, "traced": [dict(reqs[0])], "trace": trace}

    two, sixteen = reader.read(record(2)), reader.read(record(16))
    assert two > 0 and sixteen > 0
    assert 6.0 < sixteen / two <= 8.0 + 1e-9  # per-sample parts scale by 8, the weights' bytes not


@pytest.mark.parametrize("found,correct", [
    ({"a": 0.5, "b": 1.0}, True), ({"a": 0.5, "b": 1.5}, False), ({"a": float("nan"), "b": 0.0}, False),
    ({"b": 0.0}, False), ({"a": 0.0, "b": 0.0, "c": 9.0}, True)])
def test_numbers_against_their_limits(found, correct):
    from benchmarks.harness import checks

    compared = checks.compare(found, {"a": 1.0, "b": 1.0})
    assert [c["name"] for c in compared] == ["a", "b"]
    assert checks.keeps(compared) is correct
    assert checks.keeps([]) is False


def test_leaf_diffs_split_packed_projections():
    from benchmarks.harness import checks

    prog = {"blocks.0.attn.in_proj_weight": torch.zeros(6, 2), "w": torch.ones(3)}
    ref = {"blocks.0.attn.in_proj_weight": torch.arange(12.0).view(6, 2), "w": torch.ones(3)}
    d = checks.leaf_diffs(prog, ref)
    assert d["w"] == 0.0 and d["blocks.0.attn.in_proj_weight[q]"] == pytest.approx(float(torch.arange(4.0).norm()))
    gaps = checks.relative_gaps(d, checks.leaf_norms(ref), list(d))
    # the median leaf's norm (7.5) stands in for a smaller leaf's own: q reads 3.74 / 7.5
    assert gaps["blocks.0.attn.in_proj_weight[q]"] == pytest.approx(float(torch.arange(4.0).norm()) / 7.4833, 1e-4)
    assert checks.worst_of(gaps) == (1.0, "blocks.0.attn.in_proj_weight[k]") and checks.median_of(gaps)[0] == 1.0
