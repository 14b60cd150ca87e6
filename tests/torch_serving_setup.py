"""Shared set-up of the serving-path tests (tests/test_torch_serving_*.py):
one small DiT in both packages with the same weights, numpy-seeded chain
inputs, and JAX's per-step draws as the port's `noise_fn`.

The JAX model is initialized by flax, its adaLN and final layers perturbed
(as tests/test_torch_model.py does), and reaches the port through
`state_dict_from_jax_params`. Depth 4 leaves room for a Δ-cache span."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from osu_diffusion_tpu.models.dit import DiT as JaxDiT
from osu_diffusion_tpu.models.dit import DiTConfig
from osu_diffusion_tpu_torch.models.dit import DiT
from osu_diffusion_tpu_torch.train.checkpoint import state_dict_from_jax_params

HIDDEN, DEPTH, HEADS, CLASSES, CTX = 32, 4, 2, 7, 144
BAND, BUCKET = 16, 16
T = 40  # padded to 48 by the bucket: valid_len 40
SPAN = (1, 3)
CHAIN_TOL = 5e-3  # port chain vs JAX chain, as the JAX package's chain parity tests hold theirs


def jax_model(seed: int = 0, jitter: float = 0.05):
    """The JAX DiT (unrolled blocks) and its params, adaLN and final layers
    perturbed (adaLN-Zero would gate every block out of the output)."""
    model = JaxDiT(DiTConfig(hidden_size=HIDDEN, depth=DEPTH, num_heads=HEADS,
                             num_classes=CLASSES, context_size=CTX))
    params = model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, 2)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 8)), jnp.zeros((1, 8, CTX)), jnp.zeros((1,), jnp.int32),
    )["params"]
    r = np.random.RandomState(seed + 100)

    def perturb(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        a = np.array(leaf)
        if "adaLN" in names or ("final_layer" in names and "linear" in names):
            a = a + (jitter * r.randn(*a.shape)).astype(a.dtype)
        return a

    return model, jax.tree_util.tree_map_with_path(perturb, params)


def port_model(params, matmul_dtype=torch.float32, quant=False) -> DiT:
    """The port's DiT with the same weights (int8 blocks under `quant`)."""
    from osu_diffusion_tpu_torch.models.quantize import quantize_state_dict

    model = DiT(hidden_size=HIDDEN, depth=DEPTH, num_heads=HEADS, num_classes=CLASSES,
                context_size=CTX, matmul_dtype=matmul_dtype, quant=quant)
    sd = state_dict_from_jax_params(params, num_label_rows=CLASSES + 1)
    model.load_state_dict(quantize_state_dict(sd) if quant else sd)
    return model.eval()


def chain_inputs(n: int = 2, t: int = T, seed: int = 3, cfg: bool = True) -> dict:
    """numpy (z, o, c, y): with `cfg` the doubled batch [cond | uncond]
    sharing x (labels [1.. | null]); else n rows of the null class."""
    r = np.random.RandomState(seed)
    half = n // 2 if cfg else n
    z = r.randn(half, t, 2).astype(np.float32)
    o = np.cumsum(r.rand(1, t) * 300, axis=1).astype(np.float32).repeat(half, 0)
    c = r.rand(1, t, CTX).astype(np.float32).repeat(half, 0)
    if cfg:
        z, o, c = (np.concatenate([a, a]) for a in (z, o, c))
        y = np.array([1 + i for i in range(half)] + [CLASSES] * half)
    else:
        y = np.full((n,), CLASSES)
    return dict(z=z, o=o, c=c, y=y)


def to_jax(inp: dict):
    return [jnp.asarray(inp[k], jnp.int32 if k == "y" else jnp.float32) for k in "zocy"]


def to_port(inp: dict):
    return [torch.from_numpy(np.asarray(inp[k])) for k in "zocy"]


def jax_noise(rng, steps: int, t_real: int | None = None):
    """JAX's per-step draws (a chain's `jax.random.split(rng, steps)` keys)
    as the port's noise_fn; with `t_real`, drawn at that unpadded length (as
    a JAX chain run without the bucket draws them) and zero-padded to the
    port's shape."""
    keys = jax.random.split(rng, steps)

    def noise_fn(k, shape):
        draw_shape = shape if t_real is None else (shape[0], t_real, *shape[2:])
        noise = np.array(jax.random.normal(keys[k], draw_shape, jnp.float32))
        pad = [(0, 0), (0, shape[1] - draw_shape[1])] + [(0, 0)] * (len(shape) - 2)
        return torch.from_numpy(np.pad(noise, pad))

    return noise_fn


def known_rows(inp: dict, seed: int = 5):
    """In-painting inputs: known_x (values in the playfield range) and
    known_mask, False (pinned) on the second half of the rows."""
    z = inp["z"]
    known_x = np.random.RandomState(seed).rand(*z.shape).astype(np.float32)
    free = np.ones(z.shape, bool)
    free[:, z.shape[1] // 2:] = False
    return known_x, free
