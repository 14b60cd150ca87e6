"""The port's training path against the JAX package, on the CPU, at a small
size (depth 2, hidden 128, 2 heads of 64, 7 classes, T 32, batch 2-4).

process_batch and training_losses with the same draws; the dataset's
windows for one seed; the DiT's loss and every parameter gradient in
training mode (XLA path at f32, and the Pallas path in interpret mode at the
f32 and the bf16 stream, with the plain and the fused MLP backward); two
full AdamW + EMA train steps against `make_train_step`, and two with the
embed-only mask. JAX parameters reach the port through
`state_dict_from_jax_params`; inputs and draws are made with numpy (or by
jax.random on the JAX side and handed over as arrays).
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osu_diffusion_tpu.ops.pallas_attention as pa
import osu_diffusion_tpu.ops.pallas_mlp as pm
from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
from osu_diffusion_tpu.models.dit import DiT as JaxDiT
from osu_diffusion_tpu.models.dit import DiTConfig
from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
from osu_diffusion_tpu_torch.models.dit import DiT
from osu_diffusion_tpu_torch.train.checkpoint import state_dict_from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, DEPTH, HEADS, CLASSES, CTX, T = 128, 2, 2, 7, 144, 32


@pytest.fixture
def interpret_mode(monkeypatch):
    """Pallas kernels in interpret mode on the CPU."""
    for mod in (pa, pm):
        orig = mod.pl.pallas_call

        def patched(*args, _orig=orig, **kwargs):
            kwargs.setdefault("interpret", True)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod.pl, "pallas_call", patched)


def _raw_batch(n=4, seed=0):
    """Raw windows (N, T, 19) with absolute positions and rising times, the
    predecessors' coordinates, and labels."""
    r = np.random.RandomState(seed)
    raw = np.zeros((n, T, 19), np.float32)
    raw[..., 0] = r.rand(n, T) * 512
    raw[..., 1] = r.rand(n, T) * 384
    raw[..., 2] = np.cumsum(r.rand(n, T) * 300, axis=1) + 1000 * r.rand(n, 1)
    raw[np.arange(n)[:, None], np.arange(T)[None, :], 3 + r.randint(0, 16, (n, T))] = 1.0
    prev_xy = (r.rand(n, 2) * [512, 384]).astype(np.float32)
    y = r.randint(0, CLASSES, n).astype(np.int32)
    return raw, prev_xy, y


def _jax_step_draws(rng, n, num_timesteps):
    """The draws of the JAX make_train_step for one step key (after its
    fold-in), in the port's StepDraws order."""
    proc_rng, t_rng, noise_rng, _ = jax.random.split(rng, 4)
    off_rng, f_rng = jax.random.split(proc_rng)
    fx_rng, fy_rng = jax.random.split(f_rng)
    return dict(
        flip_x=np.array(jax.random.uniform(fx_rng, (n,)) < 0.5),
        flip_y=np.array(jax.random.uniform(fy_rng, (n,)) < 0.5),
        offset01=np.array(jax.random.uniform(off_rng, (n, 1))),
        t=np.array(jax.random.randint(t_rng, (n,), 0, num_timesteps)),
        noise=np.array(jax.random.normal(noise_rng, (n, T, 2), jnp.float32)),
    )


def _port_draws(d, drop):
    from osu_diffusion_tpu_torch.train.train_step import StepDraws

    return StepDraws(torch.from_numpy(d["flip_x"]), torch.from_numpy(d["flip_y"]),
                     torch.from_numpy(d["offset01"]), torch.from_numpy(d["t"]).long(),
                     torch.from_numpy(d["noise"]), torch.from_numpy(drop))


def test_process_batch_matches_jax():
    """Flips, distance context and time offsets from the same draws:
    coordinates and times exactly; the context within the sincos bound of
    test_torch_ops (f32 exp may differ by 2 ulp between XLA and torch)."""
    from osu_diffusion_tpu.data.process import process_batch as jax_process
    from osu_diffusion_tpu_torch.data.process import process_batch

    raw, prev_xy, _ = _raw_batch()
    rng = jax.random.PRNGKey(3)
    jx, jo, jc = (np.asarray(a) for a in jax_process(jnp.asarray(raw), jnp.asarray(prev_xy), rng))
    # process_batch's own draws from its key
    off_rng, f_rng = jax.random.split(rng)
    fx_rng, fy_rng = jax.random.split(f_rng)
    flip_x = np.array(jax.random.uniform(fx_rng, (4,)) < 0.5)
    flip_y = np.array(jax.random.uniform(fy_rng, (4,)) < 0.5)
    offset01 = np.array(jax.random.uniform(off_rng, (4, 1)))
    x, o, c = process_batch(torch.from_numpy(raw), torch.from_numpy(prev_xy),
                            flips=(torch.from_numpy(flip_x), torch.from_numpy(flip_y)),
                            offset01=torch.from_numpy(offset01))
    assert flip_x.any() and not flip_x.all()  # both branches taken
    np.testing.assert_array_equal(x.numpy(), jx)
    np.testing.assert_array_equal(o.numpy(), jo)
    np.testing.assert_array_equal(c[..., 128:].numpy(), jc[..., 128:])
    np.testing.assert_allclose(c[..., :128].numpy(), jc[..., :128], atol=2e-4)


@pytest.mark.parametrize("use_l1", [True, False])
def test_training_losses_match_jax(use_l1):
    """{loss, l1|mse, vb} per sample, the same model output function, x0,
    t (with t = 0 for the decoder NLL branch) and noise: rtol 1e-5 (f32
    tables and elementwise math in another order)."""
    r = np.random.RandomState(1)
    x0 = np.clip(r.rand(4, T, 2) * 1.2 - 0.1, -1, 2).astype(np.float32)
    noise = r.randn(4, T, 2).astype(np.float32)
    t = np.array([0, 1, 500, 999])
    w = r.randn(2, 4).astype(np.float32) * 0.5

    jd = jax_create("", noise_schedule="squaredcos_cap_v2", use_l1=use_l1)
    td = create_diffusion("", noise_schedule="squaredcos_cap_v2", use_l1=use_l1)
    want = jd.training_losses(lambda xt, tt: jnp.tanh(xt @ jnp.asarray(w)), jnp.asarray(x0),
                              jnp.asarray(t), jnp.asarray(noise))
    got = td.training_losses(lambda xt, tt: torch.tanh(xt @ torch.from_numpy(w)), torch.from_numpy(x0),
                             torch.from_numpy(t), torch.from_numpy(noise))
    key = "l1" if use_l1 else "mse"
    assert set(got) == {"loss", key, "vb"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)


def test_dataset_yields_the_jax_windows(tmp_path, monkeypatch):
    """For one seed, the port's loader gives the JAX loader's batches
    (windows, predecessors, labels) in the same order over two epochs, with
    the JAX side on its Python featurizer."""
    from osu_diffusion_tpu.data.dataset import BeatmapDatasetIterableFactory as JaxFactory
    from osu_diffusion_tpu.data.dataset import get_data_loader as jax_loader
    from osu_diffusion_tpu_torch.data.dataset import BeatmapDatasetIterableFactory, get_data_loader

    monkeypatch.setenv("OSU_DIFFUSION_NO_NATIVE", "1")
    src = os.path.join(ROOT, "assets", "toy_datasets", "visual_spacing")  # 5-34 points each
    for i, name in enumerate(sorted(os.listdir(src))):
        track = tmp_path / f"Track{i % 2:05d}" / "beatmaps"
        track.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(src, name), track / f"{i:06d} map.osu")

    def batches(loader_fn, factory):
        loader = loader_fn(dataset_path=str(tmp_path), start=0, end=2,
                           iterable_factory=factory(8, 3, seed=5), cycle_length=3,
                           batch_size=4, num_workers=0, shuffle=True, drop_last=True, seed=5)
        return [b for _ in range(2) for b in loader]

    want = batches(jax_loader, JaxFactory)
    got = batches(get_data_loader, BeatmapDatasetIterableFactory)
    assert len(got) == len(want) >= 4
    for ((gw, gp), gy), ((ww, wp), wy) in zip(got, want):
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gy, wy)


def test_set_epoch_replays_the_jax_epoch(tmp_path, monkeypatch):
    """BeatmapDataset.set_epoch (mirror of tests/test_data_pipeline.py's
    replay): for one seed, epoch 1 replayed by set_epoch on a fresh dataset
    gives the JAX dataset's second pass window for window, and set_epoch(0)
    its first (the two differ), both packages on the Python featurizer."""
    from osu_diffusion_tpu.data.dataset import BeatmapDataset as JaxDataset
    from osu_diffusion_tpu.data.dataset import BeatmapDatasetIterableFactory as JaxFactory
    from osu_diffusion_tpu_torch.data.dataset import BeatmapDataset, BeatmapDatasetIterableFactory

    monkeypatch.setenv("OSU_DIFFUSION_NO_NATIVE", "1")
    track = tmp_path / "Track00000" / "beatmaps"
    track.mkdir(parents=True)
    for i in range(4):
        shutil.copy(os.path.join(ROOT, "assets", "toy_datasets", "kimi_no_bouken.osu"),
                    track / f"{i:06d} map.osu")

    def make(dataset, factory):
        return dataset(dataset_path=str(tmp_path), start=0, end=1, iterable_factory=factory(64, 16, seed=7),
                       cycle_length=2, shuffle=True, seed=7)

    def stream(ds):
        return [(label, np.asarray(win), np.asarray(prev)) for (win, prev), label in ds]

    jax_ds = make(JaxDataset, JaxFactory)
    want = [stream(jax_ds), stream(jax_ds)]
    assert len(want[0]) != len(want[1]) or any(not np.array_equal(a[1], b[1]) for a, b in zip(*want))
    for epoch in (1, 0):
        ds = make(BeatmapDataset, BeatmapDatasetIterableFactory)
        ds.set_epoch(epoch)
        got = stream(ds)
        assert len(got) == len(want[epoch])
        for (gl, gw, gp), (wl, ww, wp) in zip(got, want[epoch]):
            assert gl == wl
            np.testing.assert_array_equal(gw, ww)
            np.testing.assert_array_equal(gp, wp)


def _models(use_pallas: bool, matmul_dtype, seed=0, dropout=0.2, mlp_bwd="xla", hidden=HIDDEN,
            depth=DEPTH, heads=HEADS, learn_sigma=True):
    """The JAX DiT and its params (adaLN-Zero layers perturbed, so every
    block contributes and gets gradient), and the port with the same
    weights; `hidden`, `depth`, `heads` the widths (tests/test_torch_xl_train.py
    passes DiT-XL's); without `learn_sigma` the head emits C channels."""
    jm = JaxDiT(DiTConfig(hidden_size=hidden, depth=depth, num_heads=heads, num_classes=CLASSES,
                          context_size=CTX, class_dropout_prob=dropout, flash_block=16,
                          mlp_bwd=mlp_bwd, learn_sigma=learn_sigma))
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 2)), jnp.zeros((1,), jnp.int32),
                              jnp.zeros((1, 8)), jnp.zeros((1, 8, CTX)), jnp.zeros((1,), jnp.int32))["params"]
    r = np.random.RandomState(seed)

    def perturb(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        a = np.array(leaf)
        if "adaLN" in names or ("final_layer" in names and "linear" in names):
            a = a + (0.05 * r.randn(*a.shape)).astype(a.dtype)
        return jnp.asarray(a)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    port = DiT(hidden_size=hidden, depth=depth, num_heads=heads, num_classes=CLASSES,
               context_size=CTX, class_dropout_prob=dropout, matmul_dtype=matmul_dtype,
               mlp_bwd=mlp_bwd, learn_sigma=learn_sigma)
    port.load_state_dict(state_dict_from_jax_params(params, num_label_rows=CLASSES + (dropout > 0)))
    return jm, params, port.train()


def _grads_as_state_dict(grads):
    return {k: v for k, v in state_dict_from_jax_params(
        jax.tree.map(np.asarray, grads), num_label_rows=CLASSES + 1).items()
        if not k.endswith("playfield_size")}


@pytest.mark.parametrize("path,stream", [("xla", "f32"), ("pallas", "f32"), ("pallas", "bf16"),
                                         ("fused", "f32"), ("fused", "bf16")])
def test_dit_loss_and_grads_match_jax(interpret_mode, path, stream):
    """The DiT's training loss and every parameter gradient, train=True with
    remat and a given label-drop mask, on the same x0, t and noise.

    - xla/f32 (use_pallas=False, band None; the port's plain versions at f32
      operands): loss rtol 1e-5, gradients 1e-4 of each tensor's max (f32
      sums in another order through two blocks and the VLB; measured
      4e-6).
    - pallas, band = T (the trainer's configuration): the kernels' bf16
      operands on both sides; at the f32 stream 5e-3 of each max (one bf16
      rounding flip in an operand moves a sum by 2^-8 of a term; measured
      5.3e-4), at the bf16 stream 5e-2 (measured 1.6e-2) (every activation and projection is rounded to bf16
      too, where XLA's CPU fusion and torch do not round at the same
      points). The bf16 stream is compared under the MSE loss: the L1
      gradient is sign(eps - noise), so wherever bf16 rounding moves a
      prediction across its target a whole term flips (measured: ~10% of
      the max in every tensor), while MSE's gradient is continuous.
    - fused: the pallas path with the MLP's fused backward on both sides
      (JAX `DiTConfig.mlp_bwd="fused"`, the port's `DiT(mlp_bwd="fused")`),
      at the pallas path's tolerances."""
    _check_loss_and_grads(path, stream)


def _check_loss_and_grads(path, stream, **widths):
    """test_dit_loss_and_grads_match_jax's comparison at `widths` (`_models`'s)."""
    use_pallas = path != "xla"
    md = torch.bfloat16 if use_pallas else torch.float32
    dtype = torch.bfloat16 if stream == "bf16" else torch.float32
    jm, params, port = _models(use_pallas, md, mlp_bwd="fused" if path == "fused" else "xla", **widths)
    band = T if use_pallas else None
    raw, prev_xy, y = _raw_batch(n=2, seed=4)
    r = np.random.RandomState(5)
    x0 = (r.rand(2, T, 2) * 1.2 - 0.1).astype(np.float32)
    o = np.cumsum(r.rand(2, T) * 200, axis=1).astype(np.float32)
    c = r.randn(2, T, CTX).astype(np.float32) * 0.5
    t = np.array([3, 700])
    noise = r.randn(2, T, 2).astype(np.float32)
    drop = np.array([True, False])

    use_l1 = stream == "f32"
    jd = jax_create("", noise_schedule="squaredcos_cap_v2", use_l1=use_l1)

    def jax_loss(p):
        def model_fn(xt, tt):
            return jm.apply({"params": p}, xt, tt, jnp.asarray(o), jnp.asarray(c), jnp.asarray(y),
                            train=True, band=band, use_pallas=use_pallas,
                            force_drop_ids=jnp.asarray(drop, jnp.int32),
                            dtype=jnp.bfloat16 if stream == "bf16" else jnp.float32).astype(jnp.float32)
        return jd.training_losses(model_fn, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))["loss"].mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    want = _grads_as_state_dict(want_grads)

    td = create_diffusion("", noise_schedule="squaredcos_cap_v2", use_l1=use_l1)

    def model_fn(xt, tt):
        return port(xt, tt, torch.from_numpy(o), torch.from_numpy(c), torch.from_numpy(y).long(),
                    band=band, train=True, drop=torch.from_numpy(drop), dtype=dtype)

    loss = td.training_losses(model_fn, torch.from_numpy(x0), torch.from_numpy(t),
                              torch.from_numpy(noise))["loss"].mean()
    loss.backward()
    tol = 1e-4 if path == "xla" else 5e-3 if stream == "f32" else 5e-2
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5 if path == "xla" else tol)
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    errs = {}
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        w = w.numpy()
        errs[name] = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-12)
    assert max(errs.values()) <= tol, errs


def test_make_optimizer_is_the_reference_adamw():
    """lr 1e-4, betas (0.9, 0.999), eps 1e-8 (optax's default) and weight
    decay 0 (torch's AdamW default is 0.01)."""
    from osu_diffusion_tpu_torch.train.train_step import make_optimizer

    opt = make_optimizer([torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, torch.optim.AdamW)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (1e-4, (0.9, 0.999), 1e-8, 0.0)


def test_two_train_steps_match_jax():
    """Two AdamW + EMA steps of the port's train_step against the JAX
    make_train_step from the same params, with JAX's draws fed to the port
    (class dropout 1.0, so JAX's label-drop draw is all True whatever its
    key), f32 stream, band = T through the plain banded-attention Function
    against JAX's dense band mask. The metrics agree to rtol 1e-5, params
    and EMA after both steps within 5e-6 absolute (each Adam step moves a
    weight by about lr = 1e-4 times m / sqrt(v), so this holds the update
    to ~5%; the first layer's inputs are sincos of times up to ~1e4, which
    XLA and torch compute ulps apart, see test_torch_ops, and one of its
    weights lands 3.5e-6 off, every other weight within 2e-6). Both sides' AdamW take eps 1e-4 here instead of 1e-8: with
    1e-8 the update g / (|g| + eps) of a weight whose gradient is a
    near-zero sum of cancelling terms turns on f32 summation order alone
    (measured: 124 of 745k weights off by up to 9.4e-5).

    Both sides' EMA decay is 0.5 here: at 0.9999 the EMA moves ~2e-8 in two
    steps, far inside the tolerance, so a missing or wrong EMA update would
    pass. At 0.5 it moves ~1e-4 like the params, and the EMA's movement from
    its starting copy is also held against JAX's within 5% of the largest
    movement (test_update_ema_formula holds the default decay)."""
    _check_two_train_steps()


def _check_two_train_steps(eps=1e-4, diffusion_kw=None, keys=("loss", "l1", "vb"), **widths):
    """test_two_train_steps_match_jax's comparison at `widths` (`_models`'s),
    both sides' AdamW at `eps`, both processes made by their factories from
    `diffusion_kw` (default: the trainer's L1 loss), the step's metrics
    `keys` on both sides."""
    import optax

    from osu_diffusion_tpu.parallel.train_step import create_train_state, make_train_step
    from osu_diffusion_tpu_torch.train.train_step import make_ema, train_step

    diffusion_kw = dict(use_l1=True) if diffusion_kw is None else diffusion_kw
    jm, params, port = _models(False, torch.float32, seed=2, dropout=1.0, **widths)
    jd = jax_create("", noise_schedule="squaredcos_cap_v2", **diffusion_kw)
    td = create_diffusion("", noise_schedule="squaredcos_cap_v2", **diffusion_kw)
    jax_opt = optax.adamw(1e-4, b1=0.9, b2=0.999, eps=eps, weight_decay=0.0)
    step = jax.jit(make_train_step(jm, jd, jax_opt, compute_dtype=jnp.float32, band=T, ema_decay=0.5))
    state = create_train_state(params, jax_opt)
    ema = make_ema(port)
    init = {k: v.clone() for k, v in port.state_dict().items()}
    opt = torch.optim.AdamW(port.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=eps, weight_decay=0.0)
    rng = jax.random.PRNGKey(11)
    for i in range(2):
        raw, prev_xy, y = _raw_batch(n=3, seed=10 + i)
        state, jm_metrics = step(state, (jnp.asarray(raw), jnp.asarray(prev_xy), jnp.asarray(y)), rng)
        d = _jax_step_draws(jax.random.fold_in(rng, i), 3, jd.num_timesteps)
        metrics = train_step(port, ema, opt, td, (torch.from_numpy(raw), torch.from_numpy(prev_xy),
                                                  torch.from_numpy(y).long()),
                             band=T, dtype=torch.float32, draws=_port_draws(d, np.ones(3, bool)),
                             ema_decay=0.5)
        assert set(metrics) == set(jm_metrics) == set(keys)
        for k in metrics:
            np.testing.assert_allclose(metrics[k].item(), float(jm_metrics[k]), rtol=1e-5, err_msg=k)
    for got_sd, tree in ((port.state_dict(), state.params), (ema.state_dict(), state.ema_params)):
        want = state_dict_from_jax_params(jax.tree.map(np.asarray, tree), num_label_rows=CLASSES + 1)
        for name, w in want.items():
            np.testing.assert_allclose(got_sd[name].numpy(), w.numpy(), rtol=0, atol=5e-6, err_msg=name)
    want_ema = state_dict_from_jax_params(jax.tree.map(np.asarray, state.ema_params),
                                          num_label_rows=CLASSES + 1)
    got_move = {k: ema.state_dict()[k] - init[k] for k in want_ema}
    want_move = {k: w - init[k] for k, w in want_ema.items()}
    largest = max(m.abs().max().item() for m in want_move.values())
    assert largest > 20 * 5e-6  # the EMA moved well past the tolerance above
    for name, w in want_move.items():
        np.testing.assert_allclose(got_move[name].numpy(), w.numpy(), rtol=0, atol=0.05 * largest,
                                   err_msg=name)


def test_two_embed_only_steps_match_jax():
    """One unmasked step, then two port train_steps with the trainer's
    embed-only mask against make_train_step(trainable_mask=_embed_mask(
    params, True)) (the trainer's order when its frozen epochs end is the
    reverse; this one gives the frozen weights nonzero Adam moments, which
    would move them), as test_two_train_steps_match_jax (AdamW eps 1e-4, EMA
    decay 0.5, f32 stream), at class dropout 0 so that both sides' labels are
    the batch's own (no drop draw to share) and several table rows move.
    Params and EMA within 5e-6 of JAX's; over the masked steps every
    parameter but the label table keeps its value bit for bit on both sides,
    the table moves, and AdamW counted every step for all parameters."""
    import optax

    from osu_diffusion_tpu.parallel.train_step import create_train_state, make_train_step
    from osu_diffusion_tpu.train.trainer import _embed_mask
    from osu_diffusion_tpu_torch.train.train_step import make_ema, train_step
    from osu_diffusion_tpu_torch.train.trainer import LABEL_TABLE, embed_only_mask

    jm, params, port = _models(False, torch.float32, seed=3, dropout=0.0)
    jd = jax_create("", noise_schedule="squaredcos_cap_v2", use_l1=True)
    td = create_diffusion("", noise_schedule="squaredcos_cap_v2", use_l1=True)
    jax_opt = optax.adamw(1e-4, b1=0.9, b2=0.999, eps=1e-4, weight_decay=0.0)
    steps = [jax.jit(make_train_step(jm, jd, jax_opt, compute_dtype=jnp.float32, band=T, ema_decay=0.5,
                                     trainable_mask=m)) for m in (None, _embed_mask(params, True))]
    state = create_train_state(params, jax_opt)
    ema = make_ema(port)
    opt = torch.optim.AdamW(port.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-4, weight_decay=0.0)
    mask = embed_only_mask(port)
    assert [k for k, v in mask.items() if v] == [LABEL_TABLE]
    rng = jax.random.PRNGKey(12)
    for i in range(3):
        if i == 1:  # the masked steps start
            init = {k: v.clone() for k, v in port.state_dict().items()}
            jax_init = state_dict_from_jax_params(jax.tree.map(np.asarray, state.params),
                                                  num_label_rows=CLASSES)
        raw, prev_xy, y = _raw_batch(n=3, seed=20 + i)
        state, jm_metrics = steps[i > 0](state, (jnp.asarray(raw), jnp.asarray(prev_xy), jnp.asarray(y)),
                                         rng)
        d = _jax_step_draws(jax.random.fold_in(rng, i), 3, jd.num_timesteps)
        metrics = train_step(port, ema, opt, td, (torch.from_numpy(raw), torch.from_numpy(prev_xy),
                                                  torch.from_numpy(y).long()),
                             band=T, dtype=torch.float32, draws=_port_draws(d, np.zeros(3, bool)),
                             ema_decay=0.5, trainable_mask=mask if i > 0 else None)
        for k in metrics:
            np.testing.assert_allclose(metrics[k].item(), float(jm_metrics[k]), rtol=1e-5, err_msg=k)
    want_params = state_dict_from_jax_params(jax.tree.map(np.asarray, state.params), num_label_rows=CLASSES)
    for got_sd, tree in ((port.state_dict(), state.params), (ema.state_dict(), state.ema_params)):
        want = state_dict_from_jax_params(jax.tree.map(np.asarray, tree), num_label_rows=CLASSES)
        for name, w in want.items():
            np.testing.assert_allclose(got_sd[name].numpy(), w.numpy(), rtol=0, atol=5e-6, err_msg=name)
    got = port.state_dict()
    for name, w in init.items():
        if name != LABEL_TABLE:
            assert torch.equal(got[name], w), name
            assert np.array_equal(want_params[name].numpy(), jax_init[name].numpy()), name
    moved = (got[LABEL_TABLE] - init[LABEL_TABLE]).abs().amax(dim=1)
    assert (moved > 1e-5).sum() >= 2, moved
    assert all(opt.state[p]["step"].item() == 3 for p in port.parameters())


def test_update_ema_formula():
    """ema = 0.9999 ema + 0.0001 params at the default decay, on every
    parameter: exact to f32 rounding."""
    from osu_diffusion_tpu_torch.train.train_step import make_ema, update_ema

    torch.manual_seed(0)
    model = DiT(hidden_size=64, depth=1, num_heads=1, num_classes=3, context_size=CTX)
    ema = make_ema(model)
    with torch.no_grad():
        for p in ema.parameters():
            p.copy_(torch.randn_like(p))
    before = {k: v.clone() for k, v in ema.named_parameters()}
    update_ema(ema, model)
    for name, p in model.named_parameters():
        want = before[name] * 0.9999 + p.detach() * 0.0001
        torch.testing.assert_close(dict(ema.named_parameters())[name], want, rtol=1e-6, atol=1e-7,
                                   msg=name)


def test_max_timestep_caps_the_timestep_draw(monkeypatch):
    """max_timestep=1 (the refine model) draws t = 0 for every window; with
    no cap t spans the whole schedule."""
    import osu_diffusion_tpu_torch.train.train_step as ts

    seen = []
    orig = ts.loss_terms

    def spy(model, diffusion, batch, draws, *args, **kwargs):
        seen.append(draws.t.clone())
        return orig(model, diffusion, batch, draws, *args, **kwargs)

    monkeypatch.setattr(ts, "loss_terms", spy)
    torch.manual_seed(0)
    port = DiT(hidden_size=64, depth=1, num_heads=1, num_classes=CLASSES, context_size=CTX).train()
    ema = ts.make_ema(port)
    opt = ts.make_optimizer(port.parameters())
    td = create_diffusion("", noise_schedule="squaredcos_cap_v2", use_l1=True)
    raw, prev_xy, y = _raw_batch(n=16, seed=7)
    batch = (torch.from_numpy(raw), torch.from_numpy(prev_xy), torch.from_numpy(y).long())
    for cap in (1, None):
        metrics = ts.train_step(port, ema, opt, td, batch, band=T, dtype=torch.float32,
                                generator=torch.Generator().manual_seed(3), max_timestep=cap)
        assert all(torch.isfinite(v) for v in metrics.values())
    assert (seen[0] == 0).all()
    assert seen[1].max() > 100 and seen[1].min() >= 0 and seen[1].max() < td.num_timesteps
