"""The port's context and tensor parallelism against the JAX package, on
the CPU.

- The ranged plain versions (forward with LSE, and the `BandedAttentionRanged`
  backward) against `banded_flash_attention_ranged` and its VJP (Pallas in
  interpret mode) on one device: left edge, interior, right edge with a
  padded tail, a band below one tile and a halo of two blocks; the output,
  LSE and dq on the rows [q_lo, q_hi), dk and dv on every row; and the
  first three again at DiT-XL's head dim 72 (the CP training shard, band
  128).
- `context_parallel_banded_attention` on gloo ranks (P = 2 and 4, and P = 2
  at head dim 72), against the JAX one (`use_pallas=True`) on the virtual
  8-device mesh and against the port's one-device `banded_attention`:
  output and the gradients of sum(sin(out)).
- One CP training step of a small DiT on a (1 x 4) and a (2 data x 2 model)
  grid of gloo ranks, with JAX's draws fed in, against `make_train_step`
  with the JAX mesh of the same shape.
- One tensor-parallel (TP) training step of a small DiT on (1 x 2), (1 x 4)
  and (2 x 2) grids, with the default and the fused MLP backward, against
  `make_train_step` over `shard_params`'d parameters on the JAX mesh of the
  same shape: metrics, the gathered weights, EMA and AdamW moments, each
  rank's shard shapes against JAX's, the replicas bit-identical on every
  rank of a row; and the same step with the sharded model under context
  parallelism on the (2 x 2) grid (two data ranks, each row's two ranks
  splitting the sequence) against `make_train_step(cp_mesh=...)` over
  `shard_params`'d parameters.
- `Sampler(cp=...)` on 4 ranks against the JAX CP sampler and the port's
  one-device sampler, with JAX's per-step noise, and on 2 ranks drawing
  its noise from a generator against the one-device chain of that seed.
- The train CLI on 2 gloo ranks (torchrun's environment) with
  --num-model 2 --context-parallel, its checkpoint resumed by one process;
  on 2 data ranks whose shares give different batch counts, each epoch
  ending on both together; and the flag checks (tests/test_torch_tp.py
  runs the TP train CLI).

The gloo ranks run tests/torch_cp_worker.py (no jax) as subprocesses on a
free local port; one spawned world of each size runs all of that size's
cases. Inputs are made with numpy from seeds.
"""
import functools
import os
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osu_diffusion_tpu.ops.pallas_attention as pa
from osu_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from osu_diffusion_tpu.parallel.context import (
    context_parallel_banded_attention as jax_cp_attention,
)
from osu_diffusion_tpu_torch.ops import banded_attention as ba
from osu_diffusion_tpu_torch.parallel.context import shard_bounds
from osu_diffusion_tpu_torch.parallel.sharding import LABEL_TABLE, table_rows
from osu_diffusion_tpu_torch.train.checkpoint import state_dict_from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CTX = 144
# seconds a spawned world or the two-rank CLI may take: alone they take
# 15-40 s, beside a full parallel test run up to ~3 minutes
WORKER_TIMEOUT = 420
# the JAX CP tests' tolerances: outputs rtol 2e-4 / atol 2e-5 (f32 matmuls
# summed in another order), gradients rtol 1e-3 / atol 1e-4
OUT_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = pa.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pa.pl, "pallas_call", patched)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _qkv(n, h, t, dh, seed):
    r = np.random.RandomState(seed)
    return tuple(r.randn(n, h, t, dh).astype(np.float32) for _ in range(3))


# ---------------------------------------------------------------------------
# the ranged plain versions against the JAX ranged kernel, one device
# ---------------------------------------------------------------------------

# (name, T_loc, band, shard index, shards, valid_len, head dim); the last
# three: DiT-XL's CP training shard (head dim 72, band 128) at its left
# edge, an interior shard and the right edge with a padded tail
RANGED_CASES = [
    ("left_edge", 256, 96, 0, 2, None, 16),
    ("interior", 256, 96, 1, 3, None, 16),
    ("right_edge_tail", 256, 96, 1, 2, 380, 16),
    ("band_below_tile", 128, 48, 0, 2, None, 16),
    ("halo_two_blocks", 256, 160, 1, 3, None, 16),
    ("left_edge_dh72", 256, 128, 0, 2, None, 72),
    ("interior_dh72", 256, 128, 1, 3, None, 72),
    ("right_edge_tail_dh72", 256, 128, 1, 2, 380, 72),
]


@pytest.mark.parametrize("name,t_loc,band,idx,p,valid,dh", RANGED_CASES, ids=[c[0] for c in RANGED_CASES])
def test_ranged_plain_matches_jax_ranged_kernel(name, t_loc, band, idx, p, valid, dh):
    halo = -(-band // 128) * 128
    bounds = shard_bounds(t_loc, halo, types.SimpleNamespace(model_rank=idx, num_model=p), valid)
    k_lo, k_hi, q_lo, q_hi = bounds
    t_ext = t_loc + 2 * halo
    q, k, v = _qkv(1, 2, t_ext, dh, seed=t_ext + band + idx)
    g = np.random.RandomState(7).randn(1, 2, t_ext, dh).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))

    want_o, want_lse = pa._ranged_fwd_impl(jq, jk, jv, jnp.asarray(bounds, jnp.int32), band, 128,
                                           jnp.float32, with_lse=True)
    got_o, got_lse = ba.banded_attention_ranged_fwd_lse(torch.from_numpy(q), torch.from_numpy(k),
                                                        torch.from_numpy(v), band, bounds,
                                                        torch.float32)
    rows = slice(q_lo, q_hi)
    np.testing.assert_allclose(got_o[:, :, rows].numpy(), np.asarray(want_o)[:, :, rows], **OUT_TOL)
    has_key = np.asarray(want_lse)[:, rows] > -1e29
    assert has_key.any()
    np.testing.assert_allclose(got_lse[:, rows].numpy()[has_key], np.asarray(want_lse)[:, rows][has_key],
                               **OUT_TOL)
    assert (got_lse[:, rows].numpy()[~has_key] < -1e29).all()

    def ranged(q, k, v):
        return pa.banded_flash_attention_ranged(q, k, v, band, k_lo, k_hi, block=128,
                                                matmul_dtype=jnp.float32, q_lo=q_lo, q_hi=q_hi)

    _, vjp = jax.vjp(ranged, jq, jk, jv)
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ba.banded_attention_ranged(tq, tk, tv, band, bounds, torch.float32)
    out.backward(torch.from_numpy(g))
    got = [a.grad.numpy() for a in (tq, tk, tv)]
    np.testing.assert_allclose(got[0][:, :, rows], want[0][:, :, rows], **OUT_TOL)
    assert not got[0][:, :, :q_lo].any() and not got[0][:, :, q_hi:].any()
    for a, b in zip(got[1:], want[1:]):  # dk, dv: every row
        np.testing.assert_allclose(a, b, **OUT_TOL)
    assert not got[1][:, :, :k_lo].any() and not got[1][:, :, max(k_hi, k_lo):].any()


# ---------------------------------------------------------------------------
# the spawned gloo worlds
# ---------------------------------------------------------------------------

# (name, world = shards, band, JAX block, T, valid_len, head dim): the
# configurations of tests/test_context_parallel.py, the 8-shard one on 4
# ranks; and DiT-XL's head dim 72 on the CP training window (seq-len 512
# over 2 ranks, band 128)
ATTN_CASES = [
    ("p2_band48", 2, 48, 64, 256, None, 16),
    ("p4_band128", 4, 128, 128, 1024, None, 16),
    ("p4_band160_halo2", 4, 160, 128, 1024, None, 16),
    ("p4_tail380", 4, 96, 64, 512, 380, 16),
    ("p2_band128_dh72", 2, 128, 128, 512, None, 72),
]


def _attn_case(name, p, band, block, t, valid, dh):
    q, k, v = _qkv(2, 2, t, dh, seed=t + band)
    if valid is not None:  # a loud padded tail past valid_len, as the JAX test pads it
        g = np.random.RandomState(9).randn(2, 2, t - valid, dh).astype(np.float32) * 30
        for a in (q, k, v):
            a[:, :, valid:] = g
    return {"name": name, "num_model": p, "band": band, "valid_len": valid,
            "loss_rows": t if valid is None else valid, "q": q, "k": k, "v": v}


def _raw_batch(n, t, classes, seed):
    """Raw windows (N, T, 19) with absolute positions and rising times, the
    predecessors' coordinates, and labels."""
    r = np.random.RandomState(seed)
    raw = np.zeros((n, t, 19), np.float32)
    raw[..., 0] = r.rand(n, t) * 512
    raw[..., 1] = r.rand(n, t) * 384
    raw[..., 2] = np.cumsum(r.rand(n, t) * 300, axis=1) + 1000 * r.rand(n, 1)
    raw[np.arange(n)[:, None], np.arange(t)[None, :], 3 + r.randint(0, 16, (n, t))] = 1.0
    prev_xy = (r.rand(n, 2) * [512, 384]).astype(np.float32)
    return raw, prev_xy, r.randint(0, classes, n).astype(np.int32)


def _jax_step_draws(rng, n, t, num_timesteps):
    """The draws of the JAX make_train_step for one step key (after its
    fold-in), in the port's StepDraws order (no label drop)."""
    proc_rng, t_rng, noise_rng, _ = jax.random.split(rng, 4)
    off_rng, f_rng = jax.random.split(proc_rng)
    fx_rng, fy_rng = jax.random.split(f_rng)
    return dict(
        flip_x=np.array(jax.random.uniform(fx_rng, (n,)) < 0.5),
        flip_y=np.array(jax.random.uniform(fy_rng, (n,)) < 0.5),
        offset01=np.array(jax.random.uniform(off_rng, (n, 1))),
        t=np.array(jax.random.randint(t_rng, (n,), 0, num_timesteps)),
        noise=np.array(jax.random.normal(noise_rng, (n, t, 2), jnp.float32)),
        drop=np.zeros(n, bool),
    )


TRAIN_T, TRAIN_N, TRAIN_BAND, TRAIN_CLASSES = 512, 2, 128, 5
TRAIN_CONFIG = dict(hidden_size=32, depth=2, num_heads=2, num_classes=TRAIN_CLASSES, context_size=CTX,
                    class_dropout_prob=0.0)
TRAIN_RNG = 2


def _train_setup():
    """The JAX DiT and params of the CP train-step test (adaLN-Zero layers
    perturbed, so every block contributes), its batch and its draws."""
    from osu_diffusion_tpu.models.dit import DiT, DiTConfig

    jm = DiT(DiTConfig(remat=False, **TRAIN_CONFIG))
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 2)), jnp.zeros((1,), jnp.int32),
                     jnp.zeros((1, 8)), jnp.zeros((1, 8, CTX)), jnp.zeros((1,), jnp.int32))["params"]
    r = np.random.RandomState(3)

    def perturb(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        a = np.array(leaf)
        if "adaLN" in names or ("final_layer" in names and "linear" in names):
            a = a + (0.05 * r.randn(*a.shape)).astype(a.dtype)
        return jnp.asarray(a)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    batch = _raw_batch(TRAIN_N, TRAIN_T, TRAIN_CLASSES, seed=4)
    draws = _jax_step_draws(jax.random.fold_in(jax.random.PRNGKey(TRAIN_RNG), 0), TRAIN_N, TRAIN_T, 1000)
    return jm, params, batch, draws


def _train_case(num_model, params, batch, draws):
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, params), num_label_rows=TRAIN_CLASSES)
    raw, prev_xy, y = batch
    return {"num_model": num_model, "band": TRAIN_BAND, "config": TRAIN_CONFIG,
            "state_dict": {k: v.numpy() for k, v in sd.items()},
            "raw": raw, "prev_xy": prev_xy, "y": y, "draws": draws}


# the TP step: TRAIN_CONFIG with 37 classes (a 48-row padded table, so that
# the two samples' labels, 30 and 7, sit on different model ranks at P = 2
# and 4); hidden 32 gives fc1 128 rows (64 or 32 a rank) and 192-wide block
# heads (at P = 4 a rank's 48 columns cross the 32-wide chunk boundaries)
TP_T, TP_CLASSES, TP_LABELS = 256, 37, (30, 7)
TP_CONFIG = {**TRAIN_CONFIG, "num_classes": TP_CLASSES}
# grid -> (world, num_model)
TP_GRIDS = {"1x2": (2, 2), "1x4": (4, 4), "2x2": (4, 2)}
TP_CASES = [(grid, bwd) for grid in TP_GRIDS for bwd in ("xla", "fused")]
# TP-sharded weights under CP with two data ranks: (2 data x 2 model), each
# row's two ranks splitting the sequence (256 = two shards of 128) and the shards
TP_CP_GRID, TP_CP_BWDS = "2x2", ("xla", "fused")


def _tp_setup():
    """The JAX DiT of the TP step (adaLN-Zero layers perturbed as
    _train_setup does), its params, batch and draws."""
    from osu_diffusion_tpu.models.dit import DiT, DiTConfig

    jm = DiT(DiTConfig(remat=False, **TP_CONFIG))
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 2)), jnp.zeros((1,), jnp.int32),
                     jnp.zeros((1, 8)), jnp.zeros((1, 8, CTX)), jnp.zeros((1,), jnp.int32))["params"]
    r = np.random.RandomState(3)

    def perturb(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        a = np.array(leaf)
        if "adaLN" in names or ("final_layer" in names and "linear" in names):
            a = a + (0.05 * r.randn(*a.shape)).astype(a.dtype)
        return jnp.asarray(a)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    raw, prev_xy, _ = _raw_batch(TRAIN_N, TP_T, TP_CLASSES, seed=4)
    batch = (raw, prev_xy, np.array(TP_LABELS, np.int32))
    draws = _jax_step_draws(jax.random.fold_in(jax.random.PRNGKey(TRAIN_RNG), 0), TRAIN_N, TP_T, 1000)
    return jm, params, batch, draws


def _tp_case(grid, mlp_bwd, params, batch, draws):
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, params), num_label_rows=TP_CLASSES)
    raw, prev_xy, y = batch
    return {"num_model": TP_GRIDS[grid][1], "band": TRAIN_BAND, "config": TP_CONFIG, "mlp_bwd": mlp_bwd,
            "state_dict": {k: v.numpy() for k, v in sd.items()},
            "raw": raw, "prev_xy": prev_xy, "y": y, "draws": draws}


SAMPLE_T, SAMPLE_STEPS, SAMPLE_BAND, SAMPLE_CFG, SAMPLE_SEED = 512, 3, 128, 2.0, 11
SAMPLE_CONFIG = dict(hidden_size=32, depth=2, num_heads=2, num_classes=7, context_size=CTX,
                     class_dropout_prob=0.1)


def _sample_setup():
    """The JAX CP sampler test's model, params (every leaf perturbed),
    inputs and rng (tests/test_context_parallel.py), and JAX's per-step
    noise at the padded shape."""
    from osu_diffusion_tpu.models.dit import DiT, DiTConfig

    model = DiT(DiTConfig(**SAMPLE_CONFIG))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 8, 2)), jnp.zeros((2,), jnp.int32),
                        jnp.zeros((2, 8)), jnp.zeros((2, 8, CTX)), jnp.zeros((2,), jnp.int32))["params"]
    leaves, td = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(5), len(leaves))
    params = jax.tree_util.tree_unflatten(
        td, [leaf + 0.05 * jax.random.normal(k, leaf.shape) for leaf, k in zip(leaves, keys)])
    z = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, SAMPLE_T, 2)))
    o = np.array(jnp.cumsum(jnp.ones((2, SAMPLE_T)), axis=1) * 100)
    c = np.array(jax.random.uniform(jax.random.PRNGKey(2), (2, SAMPLE_T, CTX)))
    y = np.array([3, 7], np.int32)
    rng = jax.random.PRNGKey(3)
    noise = np.stack([np.asarray(jax.random.normal(k, (2, SAMPLE_T, 2), jnp.float32))
                      for k in jax.random.split(rng, SAMPLE_STEPS)])
    return model, params, (z, o, c, y), rng, noise


def _sample_case(params, inputs, num_model, noise=None, seed=None):
    """The sampler's weights and inputs, and its per-step noise or the seed
    of the generator it draws from."""
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                    num_label_rows=SAMPLE_CONFIG["num_classes"] + 1)
    z, o, c, y = inputs
    draws = {"noise": noise} if seed is None else {"seed": seed}
    return {"num_model": num_model, "band": SAMPLE_BAND, "config": SAMPLE_CONFIG, "steps": SAMPLE_STEPS,
            "cfg_scale": SAMPLE_CFG, "state_dict": {k: v.numpy() for k, v in sd.items()},
            "z": z, "o": o, "c": c, "y": y, **draws}


def _spawn_world(world, workdir):
    port = str(_free_port())
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    return [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_cp_worker.py"),
                              str(r), str(world), port, str(workdir)],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]}: world 2 runs the P = 2
    attention cases, a sampler drawing from a generator and the (1 x 2) TP
    steps; world 4 the P = 4 attention cases, the (1 x 4) and (2 x 2) CP
    and TP train steps, the (2 x 2) TP-sharded CP steps and the sampler
    with JAX's noise."""
    workdir = tmp_path_factory.mktemp("cp")
    _, params, batch, draws = _train_setup()
    _, tparams, tbatch, tdraws = _tp_setup()
    _, sparams, inputs, _, noise = _sample_setup()
    cases = {
        2: {"attn": [_attn_case(*c) for c in ATTN_CASES if c[1] == 2],
            "sample": [_sample_case(sparams, inputs, 2, seed=SAMPLE_SEED)]},
        4: {"attn": [_attn_case(*c) for c in ATTN_CASES if c[1] == 4],
            "train": [_train_case(m, params, batch, draws) for m in (4, 2)],
            "sample": [_sample_case(sparams, inputs, 4, noise=noise)]},
    }
    for grid, bwd in TP_CASES:
        cases[TP_GRIDS[grid][0]].setdefault("tp", []).append(_tp_case(grid, bwd, tparams, tbatch, tdraws))
    cases[4]["tp_cp"] = [_tp_case(TP_CP_GRID, bwd, tparams, tbatch, tdraws) for bwd in TP_CP_BWDS]
    for world, c in cases.items():
        torch.save(c, workdir / f"cases_w{world}.pt")
    procs = {world: _spawn_world(world, workdir) for world in cases}  # both worlds at once
    for world, ranks in procs.items():
        for r, proc in enumerate(ranks):
            try:
                out, _ = proc.communicate(timeout=WORKER_TIMEOUT)
            except subprocess.TimeoutExpired:
                for p in (p for rs in procs.values() for p in rs):
                    p.kill()
                raise
            assert proc.returncode == 0, f"world {world} rank {r}:\n{out}"
    return {world: [torch.load(workdir / f"out_w{world}_r{r}.pt", weights_only=False)
                    for r in range(world)] for world in cases}


def _gathered(results, kind, i, key):
    """The case's per-rank slices concatenated along T."""
    return torch.cat([r[kind][i][key] for r in results], dim=2).numpy()


@pytest.mark.parametrize("name,p,band,block,t,valid,dh", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_cp_attention_matches_jax_and_one_device(worlds, name, p, band, block, t, valid, dh):
    case = _attn_case(name, p, band, block, t, valid, dh)
    i = [c[0] for c in ATTN_CASES if c[1] == p].index(name)
    results = worlds[p]
    got = {key: _gathered(results, "attn", i, key) for key in ("out", "dq", "dk", "dv")}
    rows = case["loss_rows"]
    jq, jk, jv = (jnp.asarray(case[key]) for key in ("q", "k", "v"))
    mesh = jax_make_mesh(num_model=p)

    def jax_out(q, k, v):
        with mesh:
            return jax_cp_attention(q, k, v, band, mesh, axis="model", block=block, use_pallas=True,
                                    valid_len=valid, matmul_dtype=jnp.float32)

    want_out = np.asarray(jax_out(jq, jk, jv))
    want_grads = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(jax_out(q, k, v)[:, :, :rows])),
                          argnums=(0, 1, 2))(jq, jk, jv)
    np.testing.assert_allclose(got["out"][:, :, :rows], want_out[:, :, :rows], **OUT_TOL)
    for key, w in zip(("dq", "dk", "dv"), want_grads):
        np.testing.assert_allclose(got[key], np.asarray(w), **GRAD_TOL, err_msg=key)

    # the port's own one-device banded attention on the whole sequence
    tq, tk, tv = (torch.from_numpy(case[key]).requires_grad_() for key in ("q", "k", "v"))
    one = ba.banded_attention(tq, tk, tv, band, valid, torch.float32)
    torch.sin(one[:, :, :rows]).sum().backward()
    np.testing.assert_allclose(got["out"][:, :, :rows], one.detach().numpy()[:, :, :rows], **OUT_TOL)
    for key, a in zip(("dq", "dk", "dv"), (tq, tk, tv)):
        np.testing.assert_allclose(got[key], a.grad.numpy(), **GRAD_TOL, err_msg=key)


@pytest.mark.parametrize("grid", ["1x4", "2x2"])
def test_cp_train_step_matches_jax(worlds, grid):
    """One AdamW + EMA step (AdamW eps 1e-4 and EMA decay 0.5 on both sides,
    as tests/test_torch_train.py::test_two_train_steps_match_jax argues)
    over 4 gloo ranks as (1 data x 4 model) or (2 x 2), against
    make_train_step(cp_mesh=...) on the JAX mesh of that shape: metrics rtol
    1e-5, parameters and EMA within 5e-6; every rank holds the same
    replica."""
    import optax

    from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
    from osu_diffusion_tpu.parallel.train_step import create_train_state, make_train_step

    num_model = 4 if grid == "1x4" else 2
    jm, params, (raw, prev_xy, y), _ = _train_setup()
    jd = jax_create("", noise_schedule="squaredcos_cap_v2", use_l1=True)
    opt = optax.adamw(1e-4, b1=0.9, b2=0.999, eps=1e-4, weight_decay=0.0)
    mesh = jax_make_mesh(num_model=num_model, devices=jax.devices()[:4])
    step = make_train_step(jm, jd, opt, compute_dtype=jnp.float32, band=TRAIN_BAND, ema_decay=0.5,
                           cp_mesh=mesh)
    with mesh:
        state, metrics = jax.jit(step)(create_train_state(params, opt),
                                       (jnp.asarray(raw), jnp.asarray(prev_xy), jnp.asarray(y)),
                                       jax.random.PRNGKey(TRAIN_RNG))
    results = [r["train"][0 if num_model == 4 else 1] for r in worlds[4]]
    for r in results:
        assert set(r["metrics"]) == {"loss", "l1", "vb"}
        for k, v in r["metrics"].items():
            np.testing.assert_allclose(v, float(metrics[k]), rtol=1e-5, err_msg=k)
    for key, tree in (("params", state.params), ("ema", state.ema_params)):
        want = state_dict_from_jax_params(jax.tree.map(np.asarray, tree), num_label_rows=TRAIN_CLASSES)
        for name, w in want.items():
            np.testing.assert_allclose(results[0][key][name].numpy(), w.numpy(), rtol=0, atol=5e-6,
                                       err_msg=name)
            for r in results[1:]:
                assert torch.equal(r[key][name], results[0][key][name]), name


@functools.cache
def _jax_tp_step(grid, cp=False):
    """JAX's TP step on the grid's mesh: (state, metrics, {port name: this
    model rank's shard shape}) from `shard_params` and
    `create_train_state(..., mesh)`; with `cp` the mesh's model axis splits
    the sequence too (`make_train_step(cp_mesh=mesh)`)."""
    import optax

    from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
    from osu_diffusion_tpu.parallel.sharding import shard_params
    from osu_diffusion_tpu.parallel.train_step import create_train_state, make_train_step

    world, num_model = TP_GRIDS[grid]
    jm, params, (raw, prev_xy, y), _ = _tp_setup()
    jd = jax_create("", noise_schedule="squaredcos_cap_v2", use_l1=True)
    opt = optax.adamw(1e-4, b1=0.9, b2=0.999, eps=1e-4, weight_decay=0.0)
    mesh = jax_make_mesh(num_model=num_model, devices=jax.devices()[:world])
    step = make_train_step(jm, jd, opt, compute_dtype=jnp.float32, band=TRAIN_BAND, ema_decay=0.5,
                           cp_mesh=mesh if cp else None)
    with mesh:
        sharded = shard_params(params, mesh)
        shard_shapes = state_dict_from_jax_params(jax.tree.map(
            lambda a: np.zeros(a.sharding.shard_shape(a.shape), np.float32), sharded))
        state, metrics = jax.jit(step)(create_train_state(sharded, opt, mesh),
                                       (jnp.asarray(raw), jnp.asarray(prev_xy), jnp.asarray(y)),
                                       jax.random.PRNGKey(TRAIN_RNG))
    return state, metrics, {k: tuple(v.shape) for k, v in shard_shapes.items()}


@pytest.mark.parametrize("grid,mlp_bwd", TP_CASES, ids=[f"{g}-{b}" for g, b in TP_CASES])
def test_tp_train_step_matches_jax(worlds, grid, mlp_bwd):
    """One AdamW + EMA step (AdamW eps 1e-4, EMA decay 0.5, as
    test_cp_train_step_matches_jax) with the weights sharded over the model
    ranks of a (1 x 2), (1 x 4) or (2 x 2) grid of gloo ranks, against
    make_train_step over shard_params'd parameters on the JAX mesh of that
    shape (the JAX step's MLP is its plain one: its backward options are
    Pallas-only). Metrics rtol 1e-5; the gathered parameters, EMA and AdamW
    moments within 5e-6 (the label table's padded rows left out); each
    rank's tensors of JAX's shard shapes; the replicated tensors the same
    bits on every rank of a row."""
    world, num_model = TP_GRIDS[grid]
    i = [c for c in TP_CASES if TP_GRIDS[c[0]][0] == world].index((grid, mlp_bwd))
    _check_tp_step([r["tp"][i] for r in worlds[world]], num_model, *_jax_tp_step(grid))


@pytest.mark.parametrize("mlp_bwd", TP_CP_BWDS)
def test_tp_cp_train_step_matches_jax(worlds, mlp_bwd):
    """One AdamW + EMA step with --num-model 2 --context-parallel over a
    sharded model on a (2 data x 2 model) grid of gloo ranks: each rank
    holds its shards and half the sequence of its data rank's windows, so a sharded
    parameter's gradient is summed over the row (the shards' gathers) and
    then over the column, a replicated one over the world
    (train/train_step.py). Against make_train_step(cp_mesh=mesh) over
    shard_params'd parameters on the JAX (2 x 2) mesh, with
    test_tp_train_step_matches_jax's tolerances: metrics rtol 1e-5, the
    gathered parameters, EMA and AdamW moments within 5e-6."""
    results = [r["tp_cp"][TP_CP_BWDS.index(mlp_bwd)] for r in worlds[TP_GRIDS[TP_CP_GRID][0]]]
    _check_tp_step(results, TP_GRIDS[TP_CP_GRID][1], *_jax_tp_step(TP_CP_GRID, cp=True))


def _check_tp_step(results, num_model, state, metrics, shard_shapes):
    """Every rank's metrics, gathered parameters, EMA and AdamW moments
    against JAX's step; each rank's tensors of JAX's shard shapes, the
    replicated ones the same bits on every rank of a row."""
    for r in results:
        assert set(r["metrics"]) == {"loss", "l1", "vb"}
        for k, v in r["metrics"].items():
            np.testing.assert_allclose(v, float(metrics[k]), rtol=1e-5, err_msg=k)
    adam = state.opt_state[0]
    for key, tree in (("params", state.params), ("ema", state.ema_params), ("exp_avg", adam.mu),
                      ("exp_avg_sq", adam.nu)):
        want = state_dict_from_jax_params(jax.tree.map(np.asarray, tree), num_label_rows=TP_CLASSES)
        for name, w in want.items():
            if key.startswith("exp") and name not in results[0][key]:
                continue  # a buffer (playfield_size) has no moments
            for r in results:
                np.testing.assert_allclose(r[key][name].numpy(), w.numpy(), rtol=0, atol=5e-6,
                                           err_msg=f"{key} {name}")
    for rank, r in enumerate(results):
        row = results[rank - rank % num_model:rank - rank % num_model + num_model]
        for name, v in r["local"].items():
            if name.endswith("playfield_size"):
                continue
            assert tuple(v.shape) == shard_shapes[name], (name, rank)
            whole = (table_rows(TP_CLASSES),) if name == LABEL_TABLE else results[0]["params"][name].shape
            if v.shape[0] == whole[0] and tuple(v.shape) == (*whole[:1], *results[0]["params"][name].shape[1:]):  # a replica: the same bits on the row's ranks
                for other in row:
                    assert torch.equal(other["local"][name], v), (name, rank)
    assert results[0]["local"]["blocks.0.mlp.fc1.weight"].shape[0] == 128 // num_model


def test_cp_sampler_matches_jax_and_one_device(worlds):
    """A 3-step CFG chain with the sequence over 4 gloo ranks (T = 512, band
    128), the same per-step noise (JAX's), against the port's one-device
    sampler and the JAX CP sampler on its 4-way model axis. At t near T the
    x0 prediction multiplies eps by ~1e2 before the clamp, so ulp-level
    differences of one forward grow: the ranged attention sums over other
    key ranges than the one-device attention (the two agree within 2e-5 in
    test_cp_attention_matches_jax_and_one_device), and the chains differ by
    up to 3.9e-4 (measured; tolerance 1e-3). The JAX CP chain equals JAX's
    one-device chain exactly, and the port's one-device chain differs from
    it by 4.3e-3 (measured, XLA's and torch's f32 arithmetic on the sincos
    of times up to 5e4), as does the port's CP chain: tolerance 5e-3, the
    port's one-device chain tolerance
    (tests/test_torch_model.py::test_sampler_slice_matches_jax)."""
    from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
    from osu_diffusion_tpu.sampling import Sampler as JaxSampler

    model, params, (z, o, c, y), rng, noise = _sample_setup()
    mesh = jax_make_mesh(num_model=4)
    with mesh:
        want = np.asarray(JaxSampler(
            model, jax_create(str(SAMPLE_STEPS), noise_schedule="linear"), cfg_scale=SAMPLE_CFG,
            band=SAMPLE_BAND, cp_mesh=mesh)(params, jnp.asarray(z), jnp.asarray(o), jnp.asarray(c),
                                             jnp.asarray(y), rng))
    outs = [r["sample"][0]["out"].numpy() for r in worlds[4]]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])  # every rank returns the whole chain
    np.testing.assert_allclose(outs[0], want, rtol=0, atol=5e-3)

    one = _one_device_sampler(params)(*_torch_inputs(z, o, c, y),
                                      noise_fn=lambda k, shape: torch.from_numpy(noise[k]))
    np.testing.assert_allclose(outs[0], one.numpy(), rtol=0, atol=1e-3)


def _one_device_sampler(params):
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.models.dit import DiT
    from osu_diffusion_tpu_torch.sampling import Sampler

    port = DiT(matmul_dtype=torch.float32, **SAMPLE_CONFIG)
    port.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                                    num_label_rows=SAMPLE_CONFIG["num_classes"] + 1))
    return Sampler(port.eval(), create_diffusion(str(SAMPLE_STEPS)), cfg_scale=SAMPLE_CFG,
                   band=SAMPLE_BAND)


def _torch_inputs(z, o, c, y):
    return torch.from_numpy(z), torch.from_numpy(o), torch.from_numpy(c), torch.from_numpy(y).long()


def test_cp_sampler_draws_the_one_device_noise_from_a_generator(worlds):
    """Without a noise_fn each of 2 ranks draws every step's noise at the
    whole padded shape from its generator (the same seed) and keeps its
    rows: the chain is the one-device chain of that seed (atol 1e-3, as
    test_cp_sampler_matches_jax_and_one_device argues), and every rank
    returns all of it."""
    _, params, (z, o, c, y), _, _ = _sample_setup()
    outs = [r["sample"][0]["out"].numpy() for r in worlds[2]]
    np.testing.assert_array_equal(outs[1], outs[0])
    one = _one_device_sampler(params)(*_torch_inputs(z, o, c, y),
                                      generator=torch.Generator().manual_seed(SAMPLE_SEED))
    np.testing.assert_allclose(outs[0], one.numpy(), rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# the train CLI on 2 gloo ranks
# ---------------------------------------------------------------------------


def _cli_argv(data, results, *extra):
    """DiT-S, 100 classes, batch 2, seq-len 256 (two shards of 128) on the
    CPU; only kimi_no_bouken is that long."""
    return ["--data-path", data, "--data-start", "0", "--data-end", "2", "--num-classes", "100",
            "--model", "DiT-S", "--global-batch-size", "2", "--seq-len", "256", "--band", "64",
            "--stride", "32", "--num-workers", "2", "--log-every", "1", "--epochs", "50",
            "--results-dir", results, "--device", "cpu", *extra]


def _ranks_of_train_cli(argv, world: int = 2) -> list[str]:
    """train_torch.py on `world` gloo ranks in torchrun's environment; each
    rank's output, after checking that it exited 0."""
    port = str(_free_port())
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
               "MASTER_ADDR": "localhost", "MASTER_PORT": port, "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen([sys.executable, "train_torch.py", *argv], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=WORKER_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {rank}:\n{out}"
        assert f"[rank {rank} of {world}] gloo on cpu" in out
    return outs


def test_train_cli_two_ranks_context_parallel(tmp_path):
    """train_torch.py on 2 gloo ranks in torchrun's environment with
    --num-model 2 --context-parallel --dist gloo: finite "Train Loss:" lines,
    one experiment directory and one checkpoint (rank 0 writes, rank 1
    does not), "Done!"; then one process resumes from that checkpoint."""
    from osu_diffusion_tpu.evals.plot_loss import parse_losses
    from osu_diffusion_tpu_torch.cli import build_train_parser, train_main
    from test_torch_train_cli import _dataset

    data, results = str(tmp_path / "data"), str(tmp_path / "results")
    _dataset(data)
    outs = _ranks_of_train_cli(_cli_argv(data, results, "--max-steps", "2", "--ckpt-every", "2",
                                             "--num-model", "2", "--context-parallel", "--dist", "gloo"))
    assert "Train Loss:" not in outs[1]  # rank 1 logs nothing
    assert os.listdir(results) == ["000-DiT-S"]
    exp = os.path.join(results, "000-DiT-S")
    assert os.listdir(os.path.join(exp, "checkpoints")) == ["0000002.pt"]
    log = open(os.path.join(exp, "log.txt")).read()
    assert "1 data x 2 model ranks over gloo, context parallel, band 64" in log
    assert log.rstrip().endswith("Done!")
    losses = parse_losses(os.path.join(exp, "log.txt"))
    assert len(losses) == 2 and all(np.isfinite(losses))

    # the checkpoint holds the whole model: one process resumes from it
    resumed = train_main(build_train_parser().parse_args(_cli_argv(
        data, results, "--max-steps", "3", "--ckpt-every", "100",
        "--ckpt", os.path.join(exp, "checkpoints", "0000002.pt"))))
    assert resumed["final_step"] == 3 and np.isfinite(resumed["last_loss"])


def test_train_cli_two_data_ranks_end_each_epoch_together(tmp_path):
    """train_torch.py on 2 gloo data ranks (--num-model 1), 2 epochs, no
    --max-steps, where rank 0's share (two copies of kimi) gives more
    batches than rank 1's (one): each epoch ends on both ranks when rank 1's
    share runs out, so both reach "Done!" after 2 x its batch count."""
    import shutil

    from osu_diffusion_tpu.evals.plot_loss import parse_losses
    from osu_diffusion_tpu_torch.data.dataset import BeatmapDatasetIterableFactory, get_data_loader
    from test_torch_train_cli import FIXTURES

    data, results = tmp_path / "data", str(tmp_path / "results")
    for track, labels in ((0, (1, 2)), (1, (3,))):
        os.makedirs(data / f"Track{track:05d}" / "beatmaps")
        for label in labels:
            shutil.copy(os.path.join(FIXTURES, "kimi_no_bouken.osu"),
                        data / f"Track{track:05d}" / "beatmaps" / f"{label:06d} kimi.osu")
    seq_len, stride, workers = 64, 64, 2
    # each rank's share as the trainer loads it: one beatmap set, batch 2, seed rank
    counts = [sum(1 for _ in get_data_loader(
        dataset_path=str(data), start=r, end=r + 1,
        iterable_factory=BeatmapDatasetIterableFactory(seq_len, stride, seed=r), cycle_length=1,
        batch_size=2, num_workers=workers, shuffle=True, drop_last=True, seed=r)) for r in range(2)]
    assert counts[0] > counts[1] > 0

    argv = ["--data-path", str(data), "--data-start", "0", "--data-end", "2", "--num-classes", "100",
            "--model", "DiT-S", "--global-batch-size", "4", "--seq-len", str(seq_len), "--stride",
            str(stride), "--num-workers", str(workers), "--log-every", "1", "--epochs", "2",
            "--ckpt-every", "1000", "--results-dir", results, "--device", "cpu", "--dist", "gloo"]
    outs = _ranks_of_train_cli(argv)
    assert "Train Loss:" not in outs[1]
    log = open(os.path.join(results, "000-DiT-S", "log.txt")).read()
    assert "2 data x 1 model ranks over gloo" in log
    assert "Beginning epoch 1..." in log and log.rstrip().endswith("Done!")
    losses = parse_losses(os.path.join(results, "000-DiT-S", "log.txt"))
    assert len(losses) == 2 * counts[1] and all(np.isfinite(losses))


@pytest.mark.parametrize("extra,match", [
    (["--num-model", "64"], "shards of 24: tensor parallelism takes shard widths that are multiples "
                            "of 16"),
    (["--num-model", "2", "--context-parallel", "--seq-len", "200"], "multiple of num_model"),
    (["--context-parallel"], "needs --num-model > 1"),
], ids=["tp_shard_width_not_128", "seq_len_not_divisible", "cp_needs_model_ranks"])
def test_train_cli_refuses_unported_or_uneven_parallelism(tmp_path, extra, match):
    from osu_diffusion_tpu_torch.cli import build_train_parser, train_main

    args = build_train_parser().parse_args(_cli_argv(str(tmp_path), str(tmp_path / "r"), *extra))
    with pytest.raises(ValueError, match=match):
        train_main(args)
    assert not os.path.exists(tmp_path / "r")  # refused before anything was written
