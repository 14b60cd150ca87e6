"""The port's k-step train call (`--steps-per-call`) against the JAX
package's, on the CPU, at a small size (depth 2, hidden 128, 2 heads of
64, 7 classes, T 32, batch 3; the trainer runs hidden 32, depth 1).

- `train_steps` with k = 2 against `make_multi_train_step(make_train_step(
  ...), 2)` (a `lax.scan` over stacked batches) from the same params, fed
  the JAX step's draws, with and without the embed-only mask: the
  tolerances of tests/test_torch_train.py's two-step tests.
- The trainer at steps_per_call 2 against JAX's on one tiny corpus, where
  a call's buffer spans an epoch boundary, the embed-only boundary
  flushes a part-full buffer and a remainder runs at the end: the same
  final step, Train Loss steps and checkpoint steps.
- `--steps-per-call` through the train CLI and train_nodist_torch.py.
- A checkpoint whose AdamW groups say `capturable=True` (written on a
  card) resumes and steps on the CPU.

On the CPU `TrainCall` runs its k steps eagerly: its CUDA graph runs on
the card only (chip_smoke.py `[train-graph]`).
"""
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from osu_diffusion_tpu.diffusion import create_diffusion as jax_create
from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
from osu_diffusion_tpu_torch.train.checkpoint import state_dict_from_jax_params
from test_torch_train import CLASSES, T, _jax_step_draws, _models, _port_draws, _raw_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets", "toy_datasets")
K = 2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Torch's intra-op threads at 2 while this module runs (a CPU train
    step beside busy test workers crawls at one thread a core)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _stacked(seeds):
    """k batches of 3 (`_raw_batch`), stacked on a leading axis."""
    raw, prev_xy, y = (np.stack(parts) for parts in zip(*(_raw_batch(n=3, seed=s) for s in seeds)))
    return raw, prev_xy, y


@pytest.mark.parametrize("embed_only", [False, True])
def test_k_step_call_matches_jax_scan(embed_only):
    """One port `train_steps` call of 2 steps against one call of JAX's
    jitted `make_multi_train_step(..., 2)` on the same stacked batches,
    the port fed JAX's draws (the scan folds the step count into the key,
    as the single step does): each metric's 2-step mean within rtol 1e-5,
    params and EMA within 5e-6 (AdamW eps 1e-4 on both sides, EMA decay
    0.5, f32 stream: test_two_train_steps_match_jax's reasons).

    With `embed_only`, as test_two_embed_only_steps_match_jax: one
    unmasked single step first (so the frozen weights have Adam moments
    that would move them), then the masked call; class dropout 0. Every
    parameter but the label table keeps its value bit for bit over the
    call on both sides, the table moves, and AdamW counted every step."""
    import optax

    from osu_diffusion_tpu.parallel.train_step import (
        create_train_state,
        make_multi_train_step,
        make_train_step,
    )
    from osu_diffusion_tpu.train.trainer import _embed_mask
    from osu_diffusion_tpu_torch.train.train_step import make_ema, train_step, train_steps
    from osu_diffusion_tpu_torch.train.trainer import LABEL_TABLE, embed_only_mask

    dropout = 0.0 if embed_only else 1.0
    jm, params, port = _models(False, torch.float32, seed=4, dropout=dropout)
    rows = CLASSES + (dropout > 0)
    jd = jax_create("", noise_schedule="squaredcos_cap_v2", use_l1=True)
    td = create_diffusion("", noise_schedule="squaredcos_cap_v2", use_l1=True)
    jax_opt = optax.adamw(1e-4, b1=0.9, b2=0.999, eps=1e-4, weight_decay=0.0)
    state = create_train_state(params, jax_opt)
    ema = make_ema(port)
    opt = torch.optim.AdamW(port.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-4, weight_decay=0.0)
    rng = jax.random.PRNGKey(13)
    drop = np.full(3, dropout > 0)

    def draws(step):
        return _port_draws(_jax_step_draws(jax.random.fold_in(rng, step), 3, jd.num_timesteps), drop)

    def single(jax_mask=None):
        return make_train_step(jm, jd, jax_opt, compute_dtype=jnp.float32, band=T, ema_decay=0.5,
                               trainable_mask=jax_mask)

    step = 0
    if embed_only:  # one unmasked step first
        raw, prev_xy, y = _raw_batch(n=3, seed=30)
        state, _ = jax.jit(single())(state, (jnp.asarray(raw), jnp.asarray(prev_xy), jnp.asarray(y)), rng)
        train_step(port, ema, opt, td, (torch.from_numpy(raw), torch.from_numpy(prev_xy),
                                        torch.from_numpy(y).long()),
                   band=T, dtype=torch.float32, draws=draws(0), ema_decay=0.5)
        step = 1
    init = {k: v.clone() for k, v in port.state_dict().items()}
    jax_init = state_dict_from_jax_params(jax.tree.map(np.asarray, state.params), num_label_rows=rows)

    raw, prev_xy, y = _stacked(range(40, 40 + K))
    multi = jax.jit(make_multi_train_step(single(_embed_mask(params, True) if embed_only else None), K))
    state, jm_metrics = multi(state, (jnp.asarray(raw), jnp.asarray(prev_xy), jnp.asarray(y)), rng)
    metrics = train_steps(port, ema, opt, td, (torch.from_numpy(raw), torch.from_numpy(prev_xy),
                                               torch.from_numpy(y).long()),
                          draws=[draws(step + i) for i in range(K)], band=T, dtype=torch.float32,
                          ema_decay=0.5, trainable_mask=embed_only_mask(port) if embed_only else None)
    assert set(metrics) == set(jm_metrics) == {"loss", "l1", "vb"}
    for k in metrics:
        assert metrics[k].shape == ()
        np.testing.assert_allclose(metrics[k].item(), float(jm_metrics[k]), rtol=1e-5, err_msg=k)
    assert int(state.step) == step + K
    assert all(opt.state[p]["step"].item() == step + K for p in port.parameters())
    want_params = state_dict_from_jax_params(jax.tree.map(np.asarray, state.params), num_label_rows=rows)
    for got_sd, tree in ((port.state_dict(), state.params), (ema.state_dict(), state.ema_params)):
        want = state_dict_from_jax_params(jax.tree.map(np.asarray, tree), num_label_rows=rows)
        for name, w in want.items():
            np.testing.assert_allclose(got_sd[name].numpy(), w.numpy(), rtol=0, atol=5e-6, err_msg=name)
    got = port.state_dict()
    moved = [name for name, w in init.items() if not torch.equal(got[name], w)]
    if embed_only:
        assert moved == [LABEL_TABLE]
        assert [n for n, w in jax_init.items() if not np.array_equal(want_params[n].numpy(), w.numpy())] \
            == [LABEL_TABLE]
    else:
        assert moved


def _toy_corpus(root):
    """tests/test_trainer_e2e.py's corpus: 8 stream fixtures over two Track
    folders, and kimi_no_bouken."""
    for i in range(2):
        os.makedirs(os.path.join(root, f"Track{i:05d}", "beatmaps"))
    for idx, name in enumerate(sorted(os.listdir(os.path.join(ASSETS, "stream")))[:8]):
        shutil.copy(os.path.join(ASSETS, "stream", name),
                    os.path.join(root, f"Track{idx % 2:05d}", "beatmaps", f"{idx:06d} map.osu"))
    shutil.copy(os.path.join(ASSETS, "kimi_no_bouken.osu"),
                os.path.join(root, "Track00000", "beatmaps", "000099 kimi.osu"))
    return root


# seq-len 16, stride 8, batch 24: 3 batches an epoch on the toy corpus
CALL_RUN = dict(num_classes=100, data_start=0, data_end=2, global_batch_size=24, num_workers=0,
                seq_len=16, stride=8, epochs=4, embed_only_epochs=1, log_every=3, ckpt_every=4,
                steps_per_call=K, use_bf16=False)


def _logged_steps(experiment_dir):
    with open(os.path.join(experiment_dir, "log.txt")) as f:
        return [int(s) for s in re.findall(r"\(step=(\d+)\) Train Loss:", f.read())]


def test_trainer_calls_match_jax_trainer(tmp_path, monkeypatch):
    """Both trainers at steps_per_call 2 on one tiny corpus (3 batches an
    epoch, 4 epochs, the first embed-only): calls of 2 at steps 2, 5
    (after the boundary's flushed single step 3), 7 (its batches from
    two epochs), 9, 11 and the remainder's single step 12; logs where
    `steps % 3 < n` (3, 7, 9, 12) and checkpoints where `steps % 4 < n`
    past 4 (5, 9, 12): the same final step, Train Loss steps and
    checkpoint steps on both sides, and the port's checkpoints hold
    the steps they are named after."""
    from osu_diffusion_tpu.models import DiT_models as JaxModels
    from osu_diffusion_tpu.models.dit import DiT as JaxDiT
    from osu_diffusion_tpu.models.dit import DiTConfig
    from osu_diffusion_tpu.train.trainer import TrainConfig as JaxConfig
    from osu_diffusion_tpu.train.trainer import train as jax_train
    from osu_diffusion_tpu_torch.models.dit import DiT, DiT_models
    from osu_diffusion_tpu_torch.train.trainer import TrainConfig, train

    monkeypatch.setitem(JaxModels, "DiT-T", lambda **kw: JaxDiT(DiTConfig(hidden_size=32, depth=1,
                                                                          num_heads=2, **kw)))
    monkeypatch.setitem(DiT_models, "DiT-T", lambda **kw: DiT(hidden_size=32, depth=1, num_heads=2, **kw))
    data = _toy_corpus(str(tmp_path / "data"))
    want = jax_train(JaxConfig(data_path=data, results_dir=str(tmp_path / "jax"), model="DiT-T",
                               **CALL_RUN))
    got = train(TrainConfig(data_path=data, results_dir=str(tmp_path / "port"), model="DiT-T",
                            device="cpu", **CALL_RUN))
    assert got["final_step"] == want["final_step"] == 12
    assert _logged_steps(got["experiment_dir"]) == _logged_steps(want["experiment_dir"]) == [3, 7, 9, 12]
    jax_ckpts = sorted(int(n) for n in os.listdir(os.path.join(want["experiment_dir"], "checkpoints"))
                       if n.isdigit())
    port_ckpts = sorted(int(n[:-3]) for n in os.listdir(got["checkpoint_dir"]) if n.endswith(".pt"))
    assert port_ckpts == jax_ckpts == [5, 9, 12]
    for s in port_ckpts:
        ckpt = torch.load(os.path.join(got["checkpoint_dir"], f"{s:07d}.pt"), weights_only=True)
        assert ckpt["step"] == s and all(v["step"].item() == s for v in ckpt["opt"]["state"].values())
    with open(os.path.join(got["experiment_dir"], "log.txt")) as f:
        log = f.read()
    assert f"{K} optimizer steps a call, run eagerly on cpu" in log
    assert log.index("Beginning epoch 1") < log.index("(step=0000003)") \
        < log.index("Un-freezing non-embedding layers")
    assert np.isfinite(got["last_loss"])


@pytest.mark.parametrize("launcher", ["train", "train_nodist"])
def test_steps_per_call_flag_reaches_the_config(launcher, monkeypatch):
    """--steps-per-call 4 gives TrainConfig.steps_per_call 4, JAX's parse of
    the same arguments the same value, through the train command and
    through train_nodist_torch.py (which adds max_timestep 1 only)."""
    import runpy
    import sys

    from osu_diffusion_tpu.cli import build_train_parser as jax_parser
    from osu_diffusion_tpu.cli import train_config_kwargs as jax_kwargs
    from osu_diffusion_tpu_torch.cli import build_train_parser, train_config_kwargs
    from osu_diffusion_tpu_torch.train import trainer

    argv = ["--data-path", "d", "--model", "DiT-S", "--steps-per-call", "4"]
    assert jax_kwargs(jax_parser().parse_args(argv))["steps_per_call"] == 4
    want = trainer.TrainConfig(**train_config_kwargs(build_train_parser().parse_args(argv)))
    assert want.steps_per_call == 4
    if launcher == "train":
        return
    seen = []
    monkeypatch.setattr(trainer, "train", seen.append)
    monkeypatch.setattr(sys, "argv", ["train_nodist_torch.py", *argv])
    runpy.run_path(os.path.join(ROOT, "train_nodist_torch.py"), run_name="__main__")
    assert seen == [trainer.TrainConfig(**{**want.__dict__, "max_timestep": 1})]


def test_card_checkpoint_resumes_and_steps_on_the_cpu(tmp_path, monkeypatch):
    """A train checkpoint whose AdamW groups say capturable=True (as one
    written on a card says) resumes on the CPU: the groups keep the live
    optimizer's capturable=False, and the run steps on from the file's
    step through a 2-step call, the step counts going on from the file's.
    `load_optimizer_state` also keeps a live capturable=True against a
    file that says False (the card's side, without stepping here)."""
    from osu_diffusion_tpu_torch.models.dit import DiT, DiT_models
    from osu_diffusion_tpu_torch.train.checkpoint import load_optimizer_state
    from osu_diffusion_tpu_torch.train.trainer import TrainConfig, train

    monkeypatch.setitem(DiT_models, "DiT-T", lambda **kw: DiT(hidden_size=32, depth=1, num_heads=2, **kw))
    data = _toy_corpus(str(tmp_path / "data"))
    run = dict(data_path=data, num_classes=100, data_start=0, data_end=2, model="DiT-T",
               global_batch_size=24, num_workers=0, seq_len=16, stride=8, log_every=1, device="cpu")
    first = train(TrainConfig(results_dir=str(tmp_path / "a"), max_steps=2, ckpt_every=2, **run))
    path = os.path.join(first["checkpoint_dir"], "0000002.pt")
    ckpt = torch.load(path, weights_only=True)
    assert all(not g["capturable"] for g in ckpt["opt"]["param_groups"])
    for g in ckpt["opt"]["param_groups"]:
        g["capturable"] = True
    for s in ckpt["opt"]["state"].values():
        s["step"] = s["step"].float()  # a capturable AdamW's f32 count
    torch.save(ckpt, path)

    resumed = train(TrainConfig(results_dir=str(tmp_path / "b"), max_steps=4, ckpt_every=4,
                                steps_per_call=2, ckpt=path, **run))
    assert resumed["final_step"] == 4 and np.isfinite(resumed["last_loss"])
    saved = torch.load(os.path.join(resumed["checkpoint_dir"], "0000004.pt"), weights_only=True)
    assert all(not g["capturable"] for g in saved["opt"]["param_groups"])
    assert all(s["step"].item() == 4 for s in saved["opt"]["state"].values())

    written = torch.nn.Parameter(torch.zeros(3))
    cpu_opt = torch.optim.AdamW([written])
    written.grad = torch.ones(3)
    cpu_opt.step()
    live = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(3))], capturable=True)
    load_optimizer_state(live, cpu_opt.state_dict())
    assert live.param_groups[0]["capturable"] is True
    (state,) = live.state.values()
    assert state["step"].dtype == torch.float32 and state["step"].item() == 1
