"""The port's tensor parallelism (parallel/sharding.py) against the JAX
package, on the CPU.

- `shard_state_dict`: every rank's shard of every parameter of a small DiT
  against the shard JAX's `shard_params` puts on that model rank of a
  (1 x P) mesh (the names mapped by `state_dict_from_jax_params`, the axes
  transposed), at P = 2 and 4 and at P = 3, which divides some axes and not
  others (JAX's `_fit_spec` replicates those); and the rules of
  `param_partition_spec` by name.
- The plain MLP half with the rank-partial argument (`partial`): the
  training forward, the plain and the fused backward, summed over P
  shards, against the unsharded plain version and against JAX `adaln_mlp`
  (Pallas in interpret mode) over weights sharded on the JAX mesh.
- The train CLI with --num-model 2 --dist gloo on 2 ranks in torchrun's
  environment beside one process of the same seed and flags: the same
  losses, one checkpoint in the one-process layout with the one process's
  values, resumed by one process and sampled by the sample command; and
  with --num-model 4 on 4 ranks, the same losses again.

(The TP training step on gloo ranks against JAX's sharded step runs in
tests/test_torch_cp.py, in the worlds that file spawns.)
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import osu_diffusion_tpu.ops.pallas_mlp as pm
from osu_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from osu_diffusion_tpu_torch.ops import adaln_mlp as tam
from osu_diffusion_tpu_torch.parallel.mesh import Mesh
from osu_diffusion_tpu_torch.parallel.sharding import (
    LABEL_TABLE,
    fit_spec,
    param_partition_spec,
    shard_state_dict,
)
from osu_diffusion_tpu_torch.train.checkpoint import state_dict_from_jax_params

CTX = 144
CONFIG = dict(hidden_size=32, depth=2, num_heads=2, num_classes=7, context_size=CTX, class_dropout_prob=0.1)
LABEL_ROWS = CONFIG["num_classes"] + 1  # the null class; JAX pads the table to 16 rows


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = pm.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pm.pl, "pallas_call", patched)


def _jax_params():
    from osu_diffusion_tpu.models.dit import DiT, DiTConfig

    model = DiT(DiTConfig(**CONFIG))
    return model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 2)), jnp.zeros((1,), jnp.int32),
                      jnp.zeros((1, 8)), jnp.zeros((1, 8, CTX)), jnp.zeros((1,), jnp.int32))["params"]


def test_param_partition_spec_rules():
    """The JAX rules in torch's layout: fc1 and the adaLN heads split on
    their output rows, fc2's weight on its input columns, the table on its
    rows; fc2's bias, attention, the embedders' MLPs and the final linear
    whole; `fit_spec` replicates an axis the degree does not divide."""
    split0 = ("model", None)
    assert param_partition_spec("blocks.3.mlp.fc1.weight", (128, 32)) == split0
    assert param_partition_spec("blocks.3.mlp.fc1.bias", (128,)) == ("model",)
    assert param_partition_spec("blocks.3.mlp.fc2.weight", (32, 128)) == (None, "model")
    assert param_partition_spec("blocks.3.mlp.fc2.bias", (32,)) == (None,)
    for name in ("blocks.0.adaLN_modulation.1.weight", "final_layer.adaLN_modulation.1.weight", LABEL_TABLE):
        assert param_partition_spec(name, (64, 32)) == split0
    for name in ("blocks.0.attn.in_proj_weight", "blocks.0.attn.out_proj.weight", "t_embedder.mlp.0.weight",
                 "xoc_embedder.mlp.0.weight", "final_layer.linear.weight"):
        assert param_partition_spec(name, (64, 32)) == (None, None)
    assert fit_spec(split0, (64, 32), 3) == (None, None)
    assert fit_spec((None, "model"), (63, 33), 3) == (None, "model")


@pytest.mark.parametrize("num_model", [2, 4, 3])
def test_shard_state_dict_matches_jax_shard_params(num_model):
    """Each model rank's shard of every tensor against the one JAX's
    shard_params places on that rank: the same shape and values (the label
    table's padded rows, random in JAX and zero here, left out). At P = 3
    fc1/fc2 (128 hidden units), the final head (64) and the 16-row table
    stay whole and the block heads (192) split, as JAX's _fit_spec has it."""
    from osu_diffusion_tpu.parallel.sharding import shard_params

    params = _jax_params()
    full = state_dict_from_jax_params(jax.tree.map(np.asarray, params), num_label_rows=LABEL_ROWS)
    mesh = jax_make_mesh(num_model=num_model, devices=jax.devices()[:num_model])
    sharded = shard_params(params, mesh)
    for rank in range(num_model):
        device = mesh.devices[0, rank]
        tree = jax.tree.map(lambda a: np.asarray(next(s.data for s in a.addressable_shards
                                                      if s.device == device)), sharded)
        want = state_dict_from_jax_params(tree)
        got = shard_state_dict(full, Mesh(1, num_model, 0, rank))
        assert set(got) == set(want)
        for name, w in want.items():
            g = got[name]
            assert tuple(g.shape) == tuple(w.shape), (name, rank)
            if name == LABEL_TABLE:
                rows = g.shape[0]
                real = max(0, min(rows, LABEL_ROWS - rank * rows)) if rows < 16 else LABEL_ROWS
                g, w = g[:real], w[:real]
            np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"{name} rank {rank}")
        fc1 = got["blocks.0.mlp.fc1.weight"].shape[0]
        assert fc1 == (128 if num_model == 3 else 128 // num_model)
        assert got["blocks.0.adaLN_modulation.1.weight"].shape[0] == 192 // num_model


# ---------------------------------------------------------------------------
# the MLP half with the rank-partial argument
# ---------------------------------------------------------------------------


def _mlp_inputs(n, t, d, hdim, seed):
    r = np.random.RandomState(seed)
    x = r.randn(n, t, d).astype(np.float32)
    shift, scale, gate = ((0.3 * r.randn(n, d)).astype(np.float32) for _ in range(3))
    w1 = (r.randn(d, hdim) / np.sqrt(d)).astype(np.float32)
    w2 = (r.randn(hdim, d) / np.sqrt(hdim)).astype(np.float32)
    b1, b2 = (0.1 * r.randn(hdim)).astype(np.float32), (0.1 * r.randn(d)).astype(np.float32)
    g = r.randn(n, t, d).astype(np.float32)
    return (x, shift, scale, gate, w1, b1, w2, b2), g


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


MLP_TOL = 1e-5  # f32 operands, the same sums split over ranks and added in another order


@pytest.mark.parametrize("num_model", [2, 4])
def test_partial_mlp_sums_to_the_whole_and_to_jax(num_model):
    """P ranks' shares of the training forward (the first whole, the others
    `partial`: no b2, no residual) and of the plain and the fused backward
    (dx without the residual's g): the sums of out, mlp, dx, dshift, dscale
    and dgate, the shards' weight gradients put together and each rank's
    db2 against the unsharded plain version and against jax.vjp of JAX
    adaln_mlp with w1/b1 split by columns and w2 by rows on a (1 x P) mesh,
    all f32; within 1e-5 of max."""
    n, t, d, hdim = 2, 16, 32, 128
    args, g = _mlp_inputs(n, t, d, hdim, seed=num_model)
    x, shift, scale, gate, w1, b1, w2, b2 = (torch.from_numpy(a) for a in args)
    gt = torch.from_numpy(g)
    f32 = torch.float32
    whole_fwd = tam.adaln_mlp_train_reference(x, shift, scale, gate, w1, b1, w2, b2, 1e-6, f32)
    whole_bwd = tam.adaln_mlp_bwd(x, shift, scale, gate, w1.t(), w2.t(), *whole_fwd[1:], gt, 1e-6, f32)

    mesh = jax_make_mesh(num_model=num_model, devices=jax.devices()[:num_model])
    specs = (P(), P(), P(), P(), P(None, "model"), P("model"), P("model", None), P())
    jargs = [jax.device_put(jnp.asarray(a), NamedSharding(mesh, s)) for a, s in zip(args, specs)]

    def jax_mlp(*a):
        return pm.adaln_mlp(*a, 8, 1e-6, jnp.float32)

    with mesh:
        jout, vjp = jax.vjp(jax.jit(jax_mlp), *jargs)
        jgrads = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    # JAX's gradients in the port's order: (dx, dshift, dscale, dgate, dw1 (D, H), db1, dw2 (H, D), db2)
    jax_whole = {"out": np.asarray(jout), "dx": jgrads[0], "dshift": jgrads[1], "dscale": jgrads[2],
                 "dgate": jgrads[3], "dfc1_w": jgrads[4].T, "db1": jgrads[5], "dfc2_w": jgrads[6].T,
                 "db2": jgrads[7]}
    port_whole = {"out": whole_fwd[0], "mlp": whole_fwd[2], "dx": whole_bwd[0], "dshift": whole_bwd[1],
                  "dscale": whole_bwd[2], "dgate": whole_bwd[3], "dfc1_w": whole_bwd[4], "db1": whole_bwd[5],
                  "dfc2_w": whole_bwd[6], "db2": whole_bwd[7]}
    hs = hdim // num_model
    for bwd in ("xla", "fused"):
        sums = dict.fromkeys(("out", "mlp", "dx", "dshift", "dscale", "dgate"), 0.0)
        cat = {"dfc1_w": [], "db1": [], "dfc2_w": []}
        for r in range(num_model):
            cols = slice(r * hs, (r + 1) * hs)
            partial = r > 0
            fc1_w, fc2_w = w1[:, cols].t().contiguous(), w2[cols].t().contiguous()
            out, a, mlp = tam.adaln_mlp_train(x, shift, scale, gate, fc1_w, b1[cols], fc2_w, b2,
                                              matmul_dtype=f32, partial=partial)
            backward = tam.adaln_mlp_bwd if bwd == "xla" else tam.adaln_mlp_bwd_fused
            dx, dshift, dscale, dgate, dfc1_w, db1, dfc2_w, db2 = backward(
                x, shift, scale, gate, fc1_w, fc2_w, a, mlp, gt, 1e-6, f32, partial=partial)
            for k, v in (("out", out), ("mlp", mlp), ("dx", dx), ("dshift", dshift), ("dscale", dscale),
                         ("dgate", dgate)):
                sums[k] = sums[k] + v
            for k, v in (("dfc1_w", dfc1_w), ("db1", db1), ("dfc2_w", dfc2_w)):
                cat[k].append(v)
            # b2 is added once in the whole: every rank holds its whole gradient
            assert _rel(db2, port_whole["db2"]) <= MLP_TOL, (bwd, r)
            if partial:  # a partial adds no residual: its share vanishes with its weights
                zero = tam.adaln_mlp_train(x, shift, scale, gate, torch.zeros_like(fc1_w), b1[cols] * 0,
                                           torch.zeros_like(fc2_w), b2, matmul_dtype=f32, partial=True)
                assert not zero[0].any() and not zero[2].any()
        got = {**sums, "dfc1_w": torch.cat(cat["dfc1_w"], 0), "db1": torch.cat(cat["db1"]),
               "dfc2_w": torch.cat(cat["dfc2_w"], 1)}
        for k, v in got.items():
            assert _rel(v, port_whole[k]) <= MLP_TOL, (bwd, k, _rel(v, port_whole[k]))
            if k in jax_whole:
                assert _rel(v, jax_whole[k]) <= MLP_TOL, (bwd, k, _rel(v, jax_whole[k]))


def test_partial_epilogue_leaves_out_the_residual_gradient():
    """The fused backward's second stage with `partial`: dx is the whole
    stage's dx less g, and h1, dshift, dscale are unchanged."""
    args, g = _mlp_inputs(2, 12, 32, 64, seed=5)
    x, shift, scale, _, w1, _, _, _ = (torch.from_numpy(a) for a in args)
    gt = torch.from_numpy(g)
    da = torch.from_numpy(np.random.RandomState(6).randn(2, 12, 64).astype(np.float32))
    whole = tam.adaln_mlp_bwd_epilogue(da, x, gt, shift, scale, w1.t().contiguous(), matmul_dtype=torch.float32)
    part = tam.adaln_mlp_bwd_epilogue(da, x, gt, shift, scale, w1.t().contiguous(), matmul_dtype=torch.float32,
                                      partial=True)
    torch.testing.assert_close(part[0] + gt, whole[0], rtol=0, atol=1e-6)
    for u, v in zip(part[1:], whole[1:]):
        assert torch.equal(u, v)


# ---------------------------------------------------------------------------
# the train CLI on gloo ranks
# ---------------------------------------------------------------------------


def _tp_argv(data, results, *extra):
    """DiT-S (hidden 1536: shards of 768 over 2 ranks, 384 over 4), 100
    classes, batch 2, seq-len 64, 2 steps with a checkpoint after the
    second, the f32 stream (so that the runs' logged losses agree to their
    printed digits), the loader thread-free (the runs then read the same
    batches in the same order)."""
    return ["--data-path", data, "--data-start", "0", "--data-end", "2", "--num-classes", "100",
            "--model", "DiT-S", "--global-batch-size", "2", "--seq-len", "64", "--stride", "32",
            "--num-workers", "0", "--log-every", "1", "--epochs", "50", "--no-use-bf16",
            "--max-steps", "2", "--ckpt-every", "2", "--results-dir", results, "--device", "cpu", *extra]


@pytest.fixture
def one_thread():
    """The in-process runs on one thread: beside a parallel test run and
    the rank subprocesses (one thread each) more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The Track dataset and one process's run of `_tp_argv`: (data path,
    its experiment directory)."""
    from osu_diffusion_tpu_torch.cli import build_train_parser, train_main
    from test_torch_train_cli import _dataset

    root = tmp_path_factory.mktemp("tp_cli")
    data = str(root / "data")
    _dataset(data)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = train_main(build_train_parser().parse_args(_tp_argv(data, str(root / "one"))))
    finally:
        torch.set_num_threads(threads)
    return data, one["experiment_dir"]


def _tp_run(one_process, results, num_model, *extra):
    """train_torch.py --num-model `num_model` --dist gloo on as many ranks
    (`extra`: more flags): its experiment directory, after checking that
    rank 0 alone logged, the mesh line and the losses, equal to the one
    process's."""
    from osu_diffusion_tpu.evals.plot_loss import parse_losses
    from test_torch_cp import _ranks_of_train_cli

    data, one_exp = one_process
    outs = _ranks_of_train_cli(_tp_argv(data, results, "--num-model", str(num_model), "--dist", "gloo",
                                        *extra), world=num_model)
    assert ["Train Loss:" in out for out in outs] == [True] + [False] * (num_model - 1)
    exp = os.path.join(results, "000-DiT-S")
    log = open(os.path.join(exp, "log.txt")).read()
    assert f"1 data x {num_model} model ranks over gloo, tensor parallel" in log
    assert log.rstrip().endswith("Done!")
    losses = parse_losses(os.path.join(exp, "log.txt"))
    assert len(losses) == 2 and all(np.isfinite(losses))
    # printed to 4 decimals
    np.testing.assert_allclose(losses, parse_losses(os.path.join(one_exp, "log.txt")), rtol=0, atol=1.5e-4)
    return exp


def test_train_cli_tensor_parallel_two_ranks(tmp_path, capsys, one_process, one_thread):
    """train_torch.py --num-model 2 --dist gloo on 2 ranks beside one
    process of the same flags: the same losses; one checkpoint (rank 0
    writes) whose model, EMA and optimizer state have the one-process
    file's keys, shapes and types and its values within 1e-6; one process
    resumes it, and the sample command samples from it."""
    from osu_diffusion_tpu_torch.beatmap import Beatmap
    from osu_diffusion_tpu_torch.cli import build_sample_parser, build_train_parser, sample_main, train_main
    from test_torch_train_cli import FIXTURES

    exp = _tp_run(one_process, str(tmp_path / "tp"), 2)
    assert os.listdir(os.path.join(exp, "checkpoints")) == ["0000002.pt"]
    tp_path = os.path.join(exp, "checkpoints", "0000002.pt")
    tp_ckpt = torch.load(tp_path, map_location="cpu", weights_only=True)
    one_ckpt = torch.load(os.path.join(one_process[1], "checkpoints", "0000002.pt"), map_location="cpu",
                          weights_only=True)
    assert set(tp_ckpt) == set(one_ckpt) and tp_ckpt["step"] == 2
    for key in ("model", "ema"):
        assert list(tp_ckpt[key]) == list(one_ckpt[key])
        for name, v in one_ckpt[key].items():
            assert tp_ckpt[key][name].shape == v.shape and tp_ckpt[key][name].dtype == v.dtype, name
            torch.testing.assert_close(tp_ckpt[key][name], v, rtol=0, atol=1e-6)
    assert tp_ckpt["opt"]["param_groups"] == one_ckpt["opt"]["param_groups"]
    assert set(tp_ckpt["opt"]["state"]) == set(one_ckpt["opt"]["state"])
    for i, state in one_ckpt["opt"]["state"].items():
        for k, v in state.items():
            assert tp_ckpt["opt"]["state"][i][k].shape == v.shape, (i, k)
            torch.testing.assert_close(tp_ckpt["opt"]["state"][i][k], v, rtol=0, atol=1e-6)

    resumed = train_main(build_train_parser().parse_args(_tp_argv(
        one_process[0], str(tmp_path / "resumed"), "--max-steps", "3", "--ckpt", tp_path)))
    assert resumed["final_step"] == 3 and np.isfinite(resumed["last_loss"])

    capsys.readouterr()
    fixture = os.path.join(FIXTURES, "visual_spacing", "test - visual spacing (OliBomby) [test12].osu")
    written = sample_main(build_sample_parser().parse_args([
        "--beatmap", fixture, "--ckpt", tp_path, "--model", "DiT-S", "--num-classes", "100",
        "--num-sampling-steps", "2", "--device", "cpu", "--results-dir", str(tmp_path / "samples")]))
    assert len(written) == 1
    assert len(Beatmap.from_path(written[0]).hit_objects()) == len(Beatmap.from_path(fixture).hit_objects())


def test_train_cli_tensor_parallel_four_ranks(tmp_path, one_process):
    """train_torch.py --num-model 4 --dist gloo on 4 ranks (each a quarter
    of DiT-S's MLPs: 384 hidden units) in torchrun's environment: the one
    process's losses, rank 0 alone logging (no checkpoint: the 2-rank test
    holds the gathered one)."""
    _tp_run(one_process, str(tmp_path / "tp"), 4, "--ckpt-every", "100")
