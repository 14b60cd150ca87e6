"""A cell's weights, made from the seed on the device, handed to both the
program and the reference.

Not the adaLN-Zero init: there every adaLN modulation and the final linear
start at zero, every gate is 0 and the model's output is 0, so no kernel's
result would reach it. Here every tensor is drawn nonzero, at the scale of
a trained checkpoint's: each product's weight at 1/sqrt(fan-in), the
adaLN modulations at 0.3/sqrt(D) (gates ~0.1 on a condition of rms ~0.5),
the final linear at 0.5/sqrt(D), the label table at 0.3, biases at 0.02.
The first layer's columns that embed the chain's own x (its 2 x 128
sinusoids of the coordinates in pixels) are drawn at X_EMBED_SCALE of the
rest: a random model is as sensitive there as its sinusoids' highest
frequency (a radian a pixel), which the ancestral chain's early steps
(x0's gain from eps ~1e4 at t = 999) amplify until the last bits of two
correct runs of the chain part ways; a trained denoiser is smooth in x.
At 1e-3 the plain chain on the CPU follows itself through 250 steps to
6e-5 where one ulp differs in a step, against 4e-2 for the bf16 stream.
One normal draw of every element from a CUDA generator, in one call, then
scaled leaf by leaf in place.
"""
from __future__ import annotations

import math

import torch

from benchmarks.reference.model import FIRST_FREQ, PLAYFIELD, param_shapes

X_EMBED_SCALE = 1e-3


def derived_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed from the run's seed and indices (the weights 0, the
    sampled labels 1, a request's generator (2, j), the checked requests 3,
    the loader 4, the train step's generator 5)."""
    h = seed
    for p in parts:
        h = (h * 1000003 + p + 1) % (2 ** 63)
    return h


def leaf_std(name: str, shape: tuple[int, ...], hidden: int) -> float:
    if name.endswith("bias"):
        return 0.02
    if name == "y_embedder.embedding_table.weight":
        return 0.3
    if "adaLN_modulation" in name:
        return 0.3 / math.sqrt(hidden)
    if name == "final_layer.linear.weight":
        return 0.5 / math.sqrt(hidden)
    return 1.0 / math.sqrt(shape[1])


def make_state(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """name -> f32 tensor on `device`, the same bits for the same seed."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    state, at = {}, 0
    for name, shape in shapes:
        size = math.prod(shape)
        leaf = flat[at:at + size].view(shape)
        at += size
        if name == "xoc_embedder.playfield_size":
            leaf.copy_(torch.tensor(PLAYFIELD, dtype=torch.float32))
        else:
            leaf.mul_(leaf_std(name, shape, cfg["hidden_size"]))
        if name == "xoc_embedder.mlp.0.weight":
            leaf[:, :cfg["in_channels"] * FIRST_FREQ].mul_(X_EMBED_SCALE)
        state[name] = leaf
    return state


def program_model(cfg: dict, device, **kwargs):
    """The program's DiT at the configuration's widths, built on `device`
    (no host-side init), in eval mode with its weights still to load."""
    from osu_diffusion_tpu_torch.models.dit import DiT

    with torch.device(device):
        return DiT(in_channels=cfg["in_channels"], context_size=cfg["context_size"],
                   hidden_size=cfg["hidden_size"], depth=cfg["depth"], num_heads=cfg["num_heads"],
                   mlp_ratio=cfg["mlp_ratio"], num_classes=cfg["num_classes"],
                   learn_sigma=cfg["learn_sigma"], **kwargs)
