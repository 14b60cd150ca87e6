"""The port's mesh paths against the JAX package, on the CPU: int8 serving
under context parallelism (CP), tensor parallelism (TP) at every shard width
the JAX rules take, and TP-sharded weights under CP.

- int8 serving under CP on 2 gloo ranks: one CFG forward and a 3-step
  chain of the int8 DiT (bf16 operands, the kernels' contract) against
  JAX's int8 model under its 2-way `cp_mesh` (Pallas in interpret mode) and
  against the port's one-process int8 model; and the ranged forward's bf16
  o (the int8 out projection's operand) against its f32 o rounded.
- TP at P = 3 on 3 gloo ranks, where 4D % 3 != 0 leaves the MLP whole on
  every rank while the block heads and the label table split: one AdamW +
  EMA step with each MLP backward against `make_train_step` over
  `shard_params`'d state on a 3-device JAX mesh.
- `check_parallel` takes (DiT-S, 8), (DiT-XL, 8) and (DiT-L, 3), with and
  without --context-parallel.
- The MLP half at shard widths 96 and 192, which the kernels take only
  zero-padded to 128 and 256: `AdalnMlp` pads inside the call, on the CPU
  as on the card, and equals the unpadded plain forward and both
  backwards bit for bit.
- TP-sharded weights under CP (--num-model 2 --context-parallel) on 2 gloo
  ranks, each MLP backward: one step against JAX's
  `make_train_step(cp_mesh=mesh)` on `create_train_state(shard_params(...),
  opt, mesh)`, each rank's shards against JAX's shards, and against the
  port's replicated CP step of the same batch.

One world of 2 and one of 3 gloo ranks of tests/torch_cp_worker.py run at
once (tests/test_torch_cp.py's spawn helpers); inputs come from numpy seeds
and JAX's draws.
"""
import functools
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osu_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from osu_diffusion_tpu_torch.ops import adaln_mlp as tam
from osu_diffusion_tpu_torch.ops import banded_attention as ba
from osu_diffusion_tpu_torch.parallel.context import shard_bounds
from osu_diffusion_tpu_torch.parallel.sharding import LABEL_TABLE, table_rows
from osu_diffusion_tpu_torch.train.checkpoint import state_dict_from_jax_params
from test_torch_cp import (  # noqa: F401 (_interpret_mode: Pallas in interpret mode, autouse)
    SAMPLE_BAND,
    SAMPLE_CFG,
    SAMPLE_CONFIG,
    SAMPLE_STEPS,
    TP_CLASSES,
    TP_CONFIG,
    TRAIN_BAND,
    TRAIN_RNG,
    WORKER_TIMEOUT,
    _interpret_mode,
    _sample_case,
    _sample_setup,
    _spawn_world,
    _torch_inputs,
    _tp_setup,
)

INT8_FORWARD_T = 500
BWDS = ("xla", "fused")
TP3 = 3  # a model degree that does not divide the tiny MLP's 128 hidden units
CP_TP = 2


def _quant_sample_case(params, inputs, noise):
    """The CP sampler test's case (JAX's noise, 2 ranks) over the int8
    model, quantized by the port, with bf16 operands, and one forward."""
    from osu_diffusion_tpu_torch.models.quantize import quantize_state_dict

    case = _sample_case(params, inputs, 2, noise=noise)
    sd = quantize_state_dict({k: torch.from_numpy(v) for k, v in case["state_dict"].items()})
    return {**case, "state_dict": {k: v.numpy() for k, v in sd.items()}, "quant": True,
            "matmul_dtype": "bfloat16", "forward_t": INT8_FORWARD_T}


def _step_case(num_model, mlp_bwd, params, batch, draws):
    sd = state_dict_from_jax_params(jax.tree.map(np.asarray, params), num_label_rows=TP_CLASSES)
    raw, prev_xy, y = batch
    return {"num_model": num_model, "band": TRAIN_BAND, "config": TP_CONFIG, "mlp_bwd": mlp_bwd,
            "state_dict": {k: v.numpy() for k, v in sd.items()},
            "raw": raw, "prev_xy": prev_xy, "y": y, "draws": draws}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: [rank 0's results, ...]}: world 2 runs the int8 CP sampler,
    the replicated CP step and the TP-sharded CP steps (each MLP
    backward); world 3 the P = 3 TP steps (each MLP backward)."""
    workdir = tmp_path_factory.mktemp("mesh")
    _, sparams, inputs, _, noise = _sample_setup()
    _, params, batch, draws = _tp_setup()
    cases = {
        CP_TP: {"sample": [_quant_sample_case(sparams, inputs, noise)],
                "train": [_step_case(CP_TP, "xla", params, batch, draws)],
                "tp_cp": [_step_case(CP_TP, bwd, params, batch, draws) for bwd in BWDS]},
        TP3: {"tp": [_step_case(TP3, bwd, params, batch, draws) for bwd in BWDS]},
    }
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


# ---------------------------------------------------------------------------
# int8 serving under context parallelism
# ---------------------------------------------------------------------------


@functools.cache
def _jax_int8():
    """JAX's int8 model of the CP sampler test's params on its 2-way CP
    mesh: (the CFG forward at INT8_FORWARD_T, the 3-step chain with JAX's
    noise), the chain also on one device."""
    from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
    from osu_diffusion_tpu.models.dit import DiT, DiTConfig
    from osu_diffusion_tpu.models.quantize import quantize_params
    from osu_diffusion_tpu.sampling import Sampler as JaxSampler

    _, params, (z, o, c, y), rng, _ = _sample_setup()
    model, qparams = DiT(DiTConfig(**SAMPLE_CONFIG, quant=True)), quantize_params(params)
    args = tuple(jnp.asarray(a) for a in (z, o, c, y))
    mesh = jax_make_mesh(num_model=CP_TP, devices=jax.devices()[:CP_TP])

    def chain(cp_mesh):
        return np.asarray(JaxSampler(model, jax_create(str(SAMPLE_STEPS), noise_schedule="linear"),
                                     cfg_scale=SAMPLE_CFG, band=SAMPLE_BAND, use_pallas=True,
                                     cp_mesh=cp_mesh)(qparams, *args, rng))

    with mesh:
        fwd = np.asarray(model.apply(
            {"params": qparams}, args[0], jnp.full((z.shape[0],), INT8_FORWARD_T), *args[1:], SAMPLE_CFG,
            band=SAMPLE_BAND, use_pallas=True, valid_len=z.shape[1], cp_mesh=mesh,
            method=DiT.forward_with_cfg))
        cp_chain = chain(mesh)
    return fwd, cp_chain, chain(None)


def _port_int8_one_process():
    """The port's int8 model (bf16 operands) in one process: (the forward,
    the chain with JAX's noise)."""
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.models.dit import DiT
    from osu_diffusion_tpu_torch.sampling import Sampler

    _, params, inputs, _, noise = _sample_setup()
    case = _quant_sample_case(params, inputs, noise)
    model = DiT(matmul_dtype=torch.bfloat16, quant=True, **SAMPLE_CONFIG)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in case["state_dict"].items()})
    model.eval()
    z, o, c, y = _torch_inputs(*inputs)
    with torch.no_grad():
        fwd = model.forward_with_cfg(z, torch.full((z.shape[0],), INT8_FORWARD_T), o, c, y, SAMPLE_CFG,
                                     band=SAMPLE_BAND, valid_len=z.shape[1])
    chain = Sampler(model, create_diffusion(str(SAMPLE_STEPS)), cfg_scale=SAMPLE_CFG, band=SAMPLE_BAND)(
        z, o, c, y, noise_fn=lambda k, shape: torch.from_numpy(noise[k]))
    return fwd.numpy(), chain.numpy()


def test_int8_cp_forward_matches_jax_and_one_process(worlds):
    """One CFG forward of the int8 DiT with the sequence over 2 gloo ranks
    (T = 512, band 128): every rank returns the same gathered output, which
    agrees with JAX's int8 model under its CP mesh and with the port's
    one-process int8 forward within the int8 forward's tolerance
    (tests/test_torch_quant.py::test_quant_forward_matches_jax_pallas_path:
    both sides round the same operands to bf16 and sum in another order, so
    now and then an operand rounds one bf16 ulp apart)."""
    outs = [r["sample"][0]["forward"].numpy() for r in worlds[CP_TP]]
    np.testing.assert_array_equal(outs[1], outs[0])
    want, _, _ = _jax_int8()
    np.testing.assert_allclose(outs[0], want, rtol=2e-3, atol=1e-3)
    one, _ = _port_int8_one_process()
    np.testing.assert_allclose(outs[0], one, rtol=2e-3, atol=1e-3)


def test_int8_cp_sampler_matches_jax_and_one_process(worlds):
    """The 3-step int8 CFG chain over 2 gloo ranks with JAX's per-step
    noise. Every rank returns the whole chain, and it is the port's
    one-process int8 chain within test_torch_cp.py's CP chain tolerance
    (atol 1e-3; measured 3.3e-5). Against JAX: JAX's int8 CP chain equals
    its one-device int8 chain exactly, and the port's CP chain is within
    that test's 5e-3 of it wherever the port's one-process int8 chain is:
    the chain multiplies eps by ~1e2 in its first x0 prediction, so where
    the int8 path's bf16 rounding of an operand flips one ulp between the
    two frameworks (2^-8 of one term of a sum), a coordinate moves up to
    the clamp, in one process as under CP (measured: the same 16 of 2048
    coordinates, at most 0.135, both ways; at most 1% of them allowed)."""
    outs = [r["sample"][0]["out"].numpy() for r in worlds[CP_TP]]
    np.testing.assert_array_equal(outs[1], outs[0])
    _, want, jax_one = _jax_int8()
    np.testing.assert_array_equal(want, jax_one)
    _, one = _port_int8_one_process()
    assert outs[0].shape == want.shape and np.isfinite(outs[0]).all()
    np.testing.assert_allclose(outs[0], one, rtol=0, atol=1e-3)
    off_cp, off_one = np.abs(outs[0] - want) > 5e-3, np.abs(one - jax_one) > 5e-3
    assert not (off_cp & ~off_one).any(), np.argwhere(off_cp & ~off_one)
    assert off_one.mean() <= 0.01, off_one.sum()


@pytest.mark.parametrize("edge", [(0, 2, None), (1, 2, 380), (1, 3, None)],
                         ids=["left_edge", "right_edge_tail", "interior"])
def test_ranged_bf16_o_is_the_f32_o_rounded(edge):
    """The ranged inference forward's o in bf16 (what the int8 block's out
    projection takes) is its f32 o rounded, in both operand types; bf16 q
    keeps bf16 o, and another o type is refused."""
    idx, p, valid = edge
    t_loc, band, halo = 256, 96, 128
    bounds = shard_bounds(t_loc, halo, types.SimpleNamespace(model_rank=idx, num_model=p), valid)
    r = np.random.RandomState(idx + p)
    q, k, v = (torch.from_numpy(r.randn(2, 3, t_loc + 2 * halo, 16).astype(np.float32)) for _ in range(3))
    for matmul_dtype in (torch.float32, torch.bfloat16):
        f32_o = ba.banded_attention_ranged(q, k, v, band, bounds, matmul_dtype)
        bf16_o = ba.banded_attention_ranged(q, k, v, band, bounds, matmul_dtype, torch.bfloat16)
        assert f32_o.dtype == torch.float32 and bf16_o.dtype == torch.bfloat16
        assert torch.equal(bf16_o, f32_o.to(torch.bfloat16))
    qb, kb, vb = (a.to(torch.bfloat16) for a in (q, k, v))
    assert ba.banded_attention_ranged(qb, kb, vb, band, bounds, out_dtype=torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="out_dtype"):
        ba.banded_attention_ranged(q, k, v, band, bounds, out_dtype=torch.float16)


# ---------------------------------------------------------------------------
# tensor parallelism at every shard width the JAX rules take
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,num_model,cp", [
    ("DiT-S", 8, False), ("DiT-XL", 8, False), ("DiT-L", 3, False),
    ("DiT-S", 8, True), ("DiT-XL", 8, True), ("DiT-L", 3, True),
], ids=["S8", "XL8", "L3", "S8-cp", "XL8-cp", "L3-cp"])
def test_check_parallel_takes_jax_degrees(model, num_model, cp):
    """DiT-S and DiT-XL over 8 model ranks (MLP shards of 192 and 576) and
    DiT-L over 3 (4096 hidden units: the MLP stays whole, as `_fit_spec`
    leaves it), with and without --context-parallel (seq-len a multiple of
    num_model * 128)."""
    from osu_diffusion_tpu_torch.train.trainer import TrainConfig, check_parallel

    seq_len = num_model * 128 if cp else 128
    config = TrainConfig(data_path="unused", model=model, num_model=num_model, context_parallel=cp,
                         seq_len=seq_len, band=128)
    assert check_parallel(config) == 128


@pytest.mark.parametrize("width", [96, 192])
@pytest.mark.parametrize("mlp_bwd", BWDS)
def test_padded_mlp_equals_unpadded(width, mlp_bwd):
    """`AdalnMlp` at a shard width the kernels take only padded (96 -> 128,
    192 -> 256): the output and the gradients of every input, each rank's
    role (whole, and partial) and both operand types, equal the unpadded
    plain forward and backward bit for bit (the padded units add exact
    zeros: the same products, in the same order)."""
    r = np.random.RandomState(width)
    n, t, d = 2, 40, 64
    for matmul_dtype in (torch.float32, torch.bfloat16):
        for partial in (False, True):
            x = torch.from_numpy(r.randn(n, t, d).astype(np.float32))
            mods = [torch.from_numpy(r.randn(n, d).astype(np.float32) * 0.3) for _ in range(3)]
            w1, w2 = (torch.from_numpy(r.randn(*s).astype(np.float32) * 0.1) for s in ((width, d), (d, width)))
            b1, b2 = (torch.from_numpy(r.randn(s).astype(np.float32) * 0.1) for s in (width, d))
            ins = [a.clone().requires_grad_() for a in (x, *mods, w1, b1, w2, b2)]
            out = tam.AdalnMlp.apply(*ins, 1e-6, matmul_dtype, mlp_bwd, partial)
            g = torch.from_numpy(r.randn(n, t, d).astype(np.float32))
            out.backward(g)
            want, a, mlp = tam.adaln_mlp_train_reference(x, *mods, w1.t(), b1, w2.t(), b2, 1e-6,
                                                         matmul_dtype, partial)
            grads = tam.adaln_mlp_bwd(x, *mods, w1, w2, a, mlp, g, 1e-6, matmul_dtype, partial)
            assert torch.equal(out, want)
            order = (0, 1, 2, 3, 4, 5, 6, 7)  # dx, dshift, dscale, dgate, dw1, db1, dw2, db2
            for i, grad in zip(order, grads):
                assert ins[i].grad.shape == ins[i].shape
                assert torch.equal(ins[i].grad, grad), (matmul_dtype, partial, i)


@functools.cache
def _jax_sharded_step(num_model, cp):
    """JAX's step on `shard_params` state over a num_model-device mesh (its
    model axis the sequence's too with `cp`): (state, metrics, {port name:
    this model rank's shard shape})."""
    import optax

    from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
    from osu_diffusion_tpu.parallel.sharding import shard_params
    from osu_diffusion_tpu.parallel.train_step import create_train_state, make_train_step

    jm, params, (raw, prev_xy, y), _ = _tp_setup()
    jd = jax_create("", noise_schedule="squaredcos_cap_v2", use_l1=True)
    opt = optax.adamw(1e-4, b1=0.9, b2=0.999, eps=1e-4, weight_decay=0.0)
    mesh = jax_make_mesh(num_model=num_model, devices=jax.devices()[:num_model])
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


def _check_sharded_step(results, num_model, cp):
    """Every rank's metrics (rtol 1e-5), gathered parameters, EMA and AdamW
    moments (atol 5e-6, test_torch_cp.py::test_tp_train_step_matches_jax's
    tolerances) against JAX's step; each rank's tensors of JAX's shard shapes
    and equal to JAX's shard of the updated parameters and EMA. Returns
    JAX's updated parameters in the port's layout."""
    state, metrics, shard_shapes = _jax_sharded_step(num_model, cp)
    for r in results:
        assert set(r["metrics"]) == {"loss", "l1", "vb"}
        for k, v in r["metrics"].items():
            np.testing.assert_allclose(v, float(metrics[k]), rtol=1e-5, err_msg=k)
    adam = state.opt_state[0]
    wants = {}
    for key, tree in (("params", state.params), ("ema", state.ema_params), ("exp_avg", adam.mu),
                      ("exp_avg_sq", adam.nu)):
        want = state_dict_from_jax_params(jax.tree.map(np.asarray, tree), num_label_rows=TP_CLASSES)
        wants[key] = want
        for name, w in want.items():
            if key.startswith("exp") and name not in results[0][key]:
                continue  # a buffer (playfield_size) has no moments
            for r in results:
                np.testing.assert_allclose(r[key][name].numpy(), w.numpy(), rtol=0, atol=5e-6,
                                           err_msg=f"{key} {name}")
    # each rank's own tensors: JAX's shard shapes, and JAX's shard of the new parameters
    padded = state_dict_from_jax_params(jax.tree.map(np.asarray, state.params))
    for rank, r in enumerate(results):
        model_rank = rank % num_model
        for name, v in r["local"].items():
            if name.endswith("playfield_size"):
                continue
            shape = shard_shapes[name]
            assert tuple(v.shape) == shape, (name, rank)
            whole = padded[name]
            dim = next((d for d, (a, b) in enumerate(zip(shape, whole.shape)) if a != b), None)
            lo = 0 if dim is None else model_rank * shape[dim]
            want = whole if dim is None else whole.narrow(dim, lo, shape[dim])
            if name == LABEL_TABLE:  # the padded rows are never looked up (JAX's keep its init)
                real = max(0, min(shape[0], TP_CLASSES - lo))
                v, want = v[:real], want[:real]
            np.testing.assert_allclose(v.numpy(), want.numpy(), rtol=0, atol=5e-6, err_msg=f"{name} rank {rank}")
    return wants["params"]


@pytest.mark.parametrize("mlp_bwd", BWDS)
def test_tp3_step_with_whole_mlp_matches_jax(worlds, mlp_bwd):
    """One AdamW + EMA step over 3 model ranks, where 4D = 128 does not
    split over 3: the MLP stays whole on every rank (no row sum), the block
    heads (192 columns) and the label table (48 padded rows) split, the
    final head (64 columns) stays whole; against JAX's step over
    `shard_params`'d state on a 3-device mesh (its MLP its plain one)."""
    results = [r["tp"][BWDS.index(mlp_bwd)] for r in worlds[TP3]]
    _check_sharded_step(results, TP3, cp=False)
    local = results[0]["local"]
    assert local["blocks.0.mlp.fc1.weight"].shape == (4 * TP_CONFIG["hidden_size"], TP_CONFIG["hidden_size"])
    assert local["blocks.0.adaLN_modulation.1.weight"].shape[0] == 6 * TP_CONFIG["hidden_size"] // TP3
    assert local[LABEL_TABLE].shape[0] == table_rows(TP_CLASSES) // TP3
    for r in results[1:]:  # the whole MLP: the same bits on every rank
        for name in ("blocks.0.mlp.fc1.weight", "blocks.1.mlp.fc2.weight", "final_layer.linear.weight"):
            assert torch.equal(r["local"][name], local[name]), name


# ---------------------------------------------------------------------------
# TP-sharded weights under context parallelism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mlp_bwd", BWDS)
def test_sharded_cp_step_matches_jax_and_replicated(worlds, mlp_bwd):
    """One step with --num-model 2 --context-parallel over a sharded model
    (each rank half of every MLP, head and the label table, and half the
    sequence): against JAX's `make_train_step(cp_mesh=mesh)` on
    `create_train_state(shard_params(params, mesh), opt, mesh)`, each
    rank's shards against JAX's shards of the updated parameters, and the
    gathered parameters and EMA against the port's replicated CP step of
    the same batch and draws (atol 5e-6: the same gradients summed in
    another order)."""
    results = [r["tp_cp"][BWDS.index(mlp_bwd)] for r in worlds[CP_TP]]
    _check_sharded_step(results, CP_TP, cp=True)
    local = results[0]["local"]
    assert local["blocks.0.mlp.fc1.weight"].shape[0] == 4 * TP_CONFIG["hidden_size"] // CP_TP
    assert local[LABEL_TABLE].shape[0] == table_rows(TP_CLASSES) // CP_TP
    replicated = worlds[CP_TP][0]["train"][0]
    for k, v in replicated["metrics"].items():
        np.testing.assert_allclose(results[0]["metrics"][k], v, rtol=1e-5, err_msg=k)
    for key in ("params", "ema"):
        for name, v in replicated[key].items():
            np.testing.assert_allclose(results[0][key][name].numpy(), v.numpy(), rtol=0, atol=5e-6,
                                       err_msg=f"{key} {name}")
