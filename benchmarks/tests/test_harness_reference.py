"""The plain reference against the port's modules at tiny sizes on the CPU
(this test imports both; the reference imports nothing of the port). On
the CPU the port runs its kernels' plain versions, which round their
operands as the kernels do, so at the sampling precision the two forwards
agree bit for bit."""
import json
import os

import pytest
import torch

from benchmarks.harness.weights import make_state, program_model
from benchmarks.reference.diffusion import Diffusion
from benchmarks.reference.model import Precision, Reference, quantize_blocks
from benchmarks.reference.train import TrainReference, draw, featurize

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CPU = torch.device("cpu")


def tiny(heads=2, hidden=64, depth=2):
    with open(os.path.join(ROOT, "benchmarks", "configs", "dit-b.json")) as f:
        cfg = json.load(f)
    cfg.update(hidden_size=hidden, depth=depth, num_heads=heads, num_classes=50)
    return cfg


def inputs(t, n=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, t, 2, generator=g)
    o = torch.cumsum(torch.rand(n, t, generator=g) * 100, 1)
    c = torch.randn(n, t, 144, generator=g)
    return x, o, c, torch.tensor([3, 50] * (n // 2)), torch.tensor([500, 20] * (n // 2))


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("t,valid,band", [(100, 100, 128), (128, 90, 32)])
def test_sampling_forward_bit_for_bit(quant, t, valid, band):
    from osu_diffusion_tpu_torch.models.quantize import quantize_state_dict

    cfg = tiny()
    state = make_state(cfg, 7, CPU)
    model = program_model(cfg, CPU, quant=quant)
    model.load_state_dict(quantize_state_dict(state) if quant else state)
    model.eval()
    x, o, c, y, ts = inputs(t)
    ref = Reference(cfg, state, Precision("f32", "bf16"), quantize_blocks(state, 2, 8) if quant else None)
    with torch.no_grad():
        got = model.forward(x, ts, o, c, y, band=band, valid_len=valid)
        want = ref.forward(x, ts, o, c, y, band, valid)
        got_cfg = model.forward_with_cfg(x, ts, o, c, y, 2.0, band=band, valid_len=valid)
        want_cfg = ref.forward_cfg(x, ts, o, c, y, 2.0, band, valid)
    assert torch.equal(got[:, :valid], want[:, :valid])
    assert torch.equal(got_cfg[:, :valid], want_cfg[:, :valid])


def test_f32_forward_against_the_f32_plain_path():
    cfg = tiny(heads=4, hidden=128)
    state = make_state(cfg, 3, CPU)
    model = program_model(cfg, CPU, matmul_dtype=torch.float32)
    model.load_state_dict(state)
    x, o, c, y, ts = inputs(64)
    with torch.no_grad():
        got = model.eval().forward(x, ts, o, c, y, band=16, valid_len=64)
    want = Reference(cfg, state).forward(x, ts, o, c, y, 16, 64)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("steps", [1, 20, 250, 1000])
def test_diffusion_tables(steps):
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion

    prog = create_diffusion(str(steps), noise_schedule="squaredcos_cap_v2")
    ref = Diffusion(steps, CPU)
    assert torch.equal(prog.timestep_map, ref.timestep_map)
    for a, b in ((prog.posterior_mean_coef1, ref.coef1), (prog.posterior_mean_coef2, ref.coef2),
                 (prog.posterior_log_variance_clipped, ref.post_logvar), (prog.log_betas, ref.log_betas),
                 (prog.sqrt_recip_alphas_cumprod, ref.sqrt_recip), (prog.sqrt_alphas_cumprod, ref.sqrt_abar)):
        assert torch.equal(a, b)


def test_ancestral_step_and_losses():
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion

    prog = create_diffusion("", noise_schedule="squaredcos_cap_v2", use_l1=True)
    ref = Diffusion(1000, CPU)
    g = torch.Generator().manual_seed(1)
    x, noise, x0 = (torch.randn(4, 30, 2, generator=g) for _ in range(3))
    out = torch.randn(4, 30, 4, generator=g) * 0.5
    t = torch.tensor([999, 500, 1, 0])
    got = prog.p_sample(lambda *a, **k: out, x, t, noise)["sample"]
    assert torch.allclose(got, ref.p_sample(out, x, t, noise), atol=1e-6)
    terms = prog.training_losses(lambda *a, **k: out, x0, t, noise)
    x_t = ref.q_sample(x0, t, noise)
    loss, l1, vb = ref.l1_vlb(out, x0, x_t, t, noise)
    assert torch.allclose(terms["loss"], loss, rtol=1e-5) and torch.allclose(terms["vb"], vb, rtol=1e-5)


def test_draws_and_featurize():
    from osu_diffusion_tpu_torch.data.process import process_batch
    from osu_diffusion_tpu_torch.train.train_step import draw_step

    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    want = draw_step(6, 32, 1000, 0.2, CPU, g1)
    got = draw(6, 32, 1000, 0.2, g2, CPU)
    for name in ("flip_x", "flip_y", "offset01", "t", "noise", "drop"):
        assert torch.equal(getattr(want, name), got[name])
    raw = torch.rand(6, 32, 19) * torch.tensor([512.0, 384.0, 1e5] + [1.0] * 16)
    prev = torch.rand(6, 2) * 300
    x, o, c = process_batch(raw, prev, flips=(want.flip_x, want.flip_y), offset01=want.offset01)
    rx, ro, rc = featurize(raw, prev, got)
    assert torch.allclose(x, rx) and torch.allclose(o, ro) and torch.allclose(c, rc, atol=1e-6)


def test_train_step_against_the_f32_program():
    """One step of the port in f32 (plain versions, no remat) and of the
    reference: the loss, every gradient and the AdamW and EMA update."""
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.train.train_step import make_ema, make_optimizer, train_step

    cfg = tiny()
    state = make_state(cfg, 11, CPU)
    model = program_model(cfg, CPU, class_dropout_prob=0.2, remat=False, matmul_dtype=torch.float32)
    model.load_state_dict(state)
    model.train()
    ema, opt = make_ema(model), make_optimizer(model.parameters())
    diffusion = create_diffusion("", noise_schedule="squaredcos_cap_v2", use_l1=True)
    g = torch.Generator().manual_seed(2)
    raw = torch.rand(8, 32, 19, generator=g) * torch.tensor([512.0, 384.0, 1e5] + [1.0] * 16)
    batch = (raw, torch.rand(8, 2, generator=g) * 300, torch.randint(0, 50, (8,), generator=g))
    gp, gr = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    metrics = train_step(model, ema, opt, diffusion, batch, band=32, dtype=torch.float32, generator=gp)
    loss = metrics["loss"]
    ref = TrainReference(cfg, state, band=32, rows=3)
    ref_loss, ref_l1 = ref.step(batch, draw(8, 32, 1000, 0.2, gr, CPU))
    assert abs(float(loss) - ref_loss) <= 1e-5 * abs(ref_loss)
    assert abs(float(metrics["l1"]) - ref_l1) <= 1e-5 * abs(ref_l1)
    params = dict(model.named_parameters())
    for name, p in params.items():
        exp_avg = opt.state[p]["exp_avg"] / 0.1
        assert torch.allclose(exp_avg, ref.first_grad[name], rtol=1e-3, atol=1e-7), name
        # where the gradient is nought to rounding (the key's bias) Adam moves
        # by round-off, at most the learning rate
        moved = ref.first_grad[name].abs() > 1e-6
        assert torch.allclose(p[moved], ref.params[name][moved], atol=1e-7), name
        assert (p - ref.params[name]).abs().max() <= 2e-4, name
    for name, p in ema.named_parameters():
        assert torch.allclose(p, ref.ema[name], atol=1e-7), name
