"""osu-diffusion-tpu, PyTorch + CUDA port (sampling path).

A second package beside `osu_diffusion_tpu`: the same class-conditional DiT
sampler in PyTorch, with the two Pallas kernels of the sampling path replaced
by hand-written CUDA C++ kernels for Hopper (sm_90a):

- ops.banded_attention  <- osu_diffusion_tpu/ops/pallas_attention.py
- ops.adaln_mlp         <- osu_diffusion_tpu/ops/pallas_mlp.py

Module layout mirrors the JAX package (beatmap/, export/, data/, ops/,
models/dit.py, diffusion/, sampling.py, train/, utils/, cli.py). Modules the
port needs from the JAX package are kept here as copies (beatmap I/O,
export, featurize, schedule), so nothing in this package imports jax or any
module of `osu_diffusion_tpu`, and importing this file imports nothing at
all.
"""

__version__ = "0.1.0"

FEATURE_SIZE = 19  # [x, y, time_ms, 16 datapoint-type one-hots]
PLAYFIELD = (512.0, 384.0)  # osu! standard playfield
CONTEXT_SIZE = FEATURE_SIZE - 3 + 128  # 144: distance embed (128) + 16 type one-hots
