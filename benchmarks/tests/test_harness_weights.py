"""The cells' weights: every tensor drawn nonzero (not adaLN-Zero), every
block's gates nonzero, the same bits for the same seed."""
import json
import os

import pytest
import torch
import torch.nn.functional as F

from benchmarks.harness.weights import X_EMBED_SCALE, make_state
from benchmarks.reference.model import Reference, param_shapes

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config(name, **small):
    with open(os.path.join(ROOT, "benchmarks", "configs", name + ".json")) as f:
        return dict(json.load(f), **small)


@pytest.mark.parametrize("name", ["dit-b", "dit-xl"])
def test_every_gate_nonzero(name):
    cfg = config(name, num_classes=100)  # the label table cut: the blocks are whole
    state = make_state(cfg, 2 ** 31 + 3, torch.device("cpu"))
    assert [n for n, _ in param_shapes(cfg)] == list(state)
    # a normal draw in f32 is exactly 0 a few times in ~10^8
    assert all(float((v == 0).float().mean()) < 1e-6 for v in state.values())
    ref = Reference(cfg, state)
    cond = ref.cond(torch.tensor([999, 500, 0]), torch.tensor([0, 7, 100]))
    for i in range(cfg["depth"]):
        w, b = state[f"blocks.{i}.adaLN_modulation.1.weight"], state[f"blocks.{i}.adaLN_modulation.1.bias"]
        gates = F.linear(F.silu(cond), w, b).chunk(6, dim=-1)
        for gate in (gates[2], gates[5]):
            assert float((gate == 0).float().mean()) < 1e-3 and 0.01 < float(gate.pow(2).mean().sqrt()) < 1.0
    assert float(state["final_layer.linear.weight"].abs().max()) > 0


def test_same_seed_same_bits_and_the_x_embedding_scale():
    cfg = config("dit-b", hidden_size=64, depth=2, num_heads=2, num_classes=10)
    a, b, c = (make_state(cfg, s, torch.device("cpu")) for s in (5, 5, 6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.mlp.fc1.weight"], c["blocks.0.mlp.fc1.weight"])
    w = a["xoc_embedder.mlp.0.weight"]
    x_cols, rest = w[:, :256].std(), w[:, 256:].std()
    assert 0.5 * X_EMBED_SCALE < float(x_cols / rest) < 2 * X_EMBED_SCALE
    assert torch.equal(a["xoc_embedder.playfield_size"], torch.tensor([512.0, 384.0]))
