"""The CUDA kernels against their plain versions, and the wrappers'
dispatch: banded attention (inference forward, forward with LSE, dq, dk/dv,
and the four ranged entries of context parallelism),
the fused adaLN-MLP (inference and training forward, the two stages of the
fused backward, int8 serving) and the
int8 projections, each alone and, where it has one, inside its autograd
Function; the Sampler's and calc_bpd_loop's CUDA graphs (the adaptive
Δ-cache's conditional IF nodes among them) against the same chains eager;
and the train call's graph (`train_step.TrainCall`) against eager train
steps.
Imports torch only (no jax), so the card's
machine runs it:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(--noconftest: tests/conftest.py sets up jax). Tests marked `cuda` skip
without a card; the rest run anywhere.
"""
import types

import pytest
import torch

from osu_diffusion_tpu_torch.ops import adaln_mlp as tam
from osu_diffusion_tpu_torch.ops import banded_attention as tba
from osu_diffusion_tpu_torch.ops import quant as tq
from osu_diffusion_tpu_torch.parallel.context import shard_bounds


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda")


def test_wrappers_take_the_plain_versions_on_cpu():
    """A CPU tensor goes to the plain version and launches nothing."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 40, 16, generator=g) for _ in range(3))
    before = tba.banded_attention.launches
    got = tba.banded_attention(q, k, v, 8, 33)
    assert torch.equal(got, tba.banded_attention_reference(q, k, v, 8, 33, torch.bfloat16))
    assert tba.banded_attention.launches == before
    x = torch.randn(2, 10, 32, generator=g)
    mod = torch.randn(2, 3, 32, generator=g) * 0.1
    w1, w2 = torch.randn(32, 128, generator=g) * 0.1, torch.randn(128, 32, generator=g) * 0.1
    b1, b2 = torch.zeros(128), torch.zeros(32)
    before = tam.adaln_mlp.launches
    got = tam.adaln_mlp(x, mod[:, 0], mod[:, 1], mod[:, 2], w1.t(), b1, w2.t(), b2)
    want = tam.adaln_mlp_reference(x, mod[:, 0], mod[:, 1], mod[:, 2], w1, b1, w2, b2,
                                   1e-6, torch.bfloat16)
    assert torch.equal(got, want)
    assert tam.adaln_mlp.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("t,valid,band", [(768, 757, 128), (200, 190, 20), (50, 50, 128), (256, 60, 16)])
def test_banded_attention_kernel_matches_plain(cuda_device, t, valid, band):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, h = 2, 3
    qkv = torch.randn((n, t, 3 * h * 64), generator=g, device=cuda_device)
    q, k, v = (a.view(n, t, h, 64).transpose(1, 2) for a in qkv.split(h * 64, dim=-1))
    before = tba.banded_attention.launches
    got = tba.banded_attention(q, k, v, band, valid)
    torch.cuda.synchronize()
    assert tba.banded_attention.launches == before + 1
    assert tba.banded_attention.body == "sm90"  # f32 q/k/v take the Hopper body too
    want = tba.banded_attention_reference(q, k, v, band, valid, torch.bfloat16)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 5e-3  # the bf16 contract, see chip_smoke.py
    assert torch.equal(tba.banded_attention(q, k, v, band, valid), got)  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("t,valid,band", [(768, 757, 128), (200, 190, 20), (50, 50, 128)])
def test_banded_attention_bf16_out_from_f32_is_the_rounded_f32_out(cuda_device, t, valid, band):
    """out_dtype=bf16 on f32 q/k/v (the int8 block's out projection takes o
    so): one launch of the Hopper body, o exactly bf16 of the f32 call's o."""
    g = torch.Generator(device=cuda_device).manual_seed(t)
    q, k, v = _qkv_heads(2, t, 3, torch.float32, g, cuda_device)
    o32 = tba.banded_attention(q, k, v, band, valid)
    before = tba.banded_attention.launches
    o16 = tba.banded_attention(q, k, v, band, valid, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert tba.banded_attention.launches == before + 1 and tba.banded_attention.body == "sm90"
    assert o16.dtype == torch.bfloat16 and o16.shape == o32.shape
    assert torch.equal(o16, o32.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,d", [(2, 768, 768), (3, 50, 768), (2, 100, 384), (1, 40, 1024),
                                   (1, 757, 1024), (3, 757, 384)])
def test_adaln_mlp_kernel_matches_plain(cuda_device, n, t, d):
    """The Hopper body (bf16 weights) against the plain version on the same
    bf16 operands, ragged T (50, 757: a last 128-row block that is part
    pad) at each of the three widths; the same bits on a second call."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape, std):
        return torch.randn(shape, generator=g, device=cuda_device) * std

    x, mod = rnd(n, t, d, std=1.0), rnd(n, 6 * d, std=0.3)
    shift, scale, gate = mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:]
    w1 = rnd(d, 4 * d, std=d ** -0.5).to(torch.bfloat16)
    w2 = rnd(4 * d, d, std=(4 * d) ** -0.5).to(torch.bfloat16)
    b1, b2 = rnd(4 * d, std=0.02), rnd(d, std=0.02)
    fc1_w, fc2_w = w1.t().contiguous(), w2.t().contiguous()
    before = tam.adaln_mlp.launches
    got = tam.adaln_mlp(x, shift, scale, gate, fc1_w, b1, fc2_w, b2)
    torch.cuda.synchronize()
    assert tam.adaln_mlp.launches == before + 1
    assert tam.adaln_mlp.body == "sm90"
    want = tam.adaln_mlp_reference(x, shift, scale, gate, w1, b1, w2, b2, 1e-6, torch.bfloat16)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 5e-3  # the bf16 contract, see chip_smoke.py
    assert torch.equal(tam.adaln_mlp(x, shift, scale, gate, fc1_w, b1, fc2_w, b2), got)


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda_device):
    q = torch.randn(1, 2, 32, 32, device=cuda_device)  # head dim 32
    with pytest.raises(ValueError):
        tba.banded_attention(q, q, q, 8)
    q = torch.randn(1, 2, 32, 64, device=cuda_device)
    with pytest.raises(ValueError):
        tba.banded_attention(q, q, q, 8, matmul_dtype=torch.float32)
    x = torch.randn(1, 8, 64, device=cuda_device)  # D = 64 has no kernel
    w1 = torch.zeros(256, 64, device=cuda_device, dtype=torch.bfloat16)
    m = torch.zeros(1, 64, device=cuda_device)
    with pytest.raises(ValueError):
        tam.adaln_mlp(x, m, m, m, w1, torch.zeros(256, device=cuda_device), w1.t().contiguous(), m[0])
    x = torch.randn(1, 8, 384, device=cuda_device)  # weights in torch's (out, in) layout only
    w1 = torch.zeros(384, 1536, device=cuda_device, dtype=torch.bfloat16)
    m = torch.zeros(1, 384, device=cuda_device)
    with pytest.raises(ValueError):
        tam.adaln_mlp(x, m, m, m, w1, torch.zeros(1536, device=cuda_device), w1.t(), m[0])
    with pytest.raises(TypeError):  # f32 weights have no kernel
        tam.adaln_mlp(x, m, m, m, w1.t().float(), torch.zeros(1536, device=cuda_device),
                      w1.float(), m[0])


def _rel(got, want) -> float:
    """max |got - want| / max |want|, in f32."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def _qkv_heads(n, t, h, dtype, g, device, dh=64):
    qkv = torch.randn((n, t, 3 * h * dh), generator=g, device=device).to(dtype)
    return [a.view(n, t, h, dh).transpose(1, 2) for a in qkv.split(h * dh, dim=-1)]


# (T, valid_len, band): the training shape's T = band = 128, T not a tile
# multiple, valid_len < T, band < T, rows with no valid key, and three
# 128-row blocks with the band reaching across them
TRAIN_ATTN_CASES = [(128, 128, 128), (200, 190, 20), (100, 77, 128), (256, 60, 16), (384, 370, 128)]

# the body each stream takes: every forward entry the Hopper body; the
# backward (attention dq and dk/dv, the fused MLP backward) bf16 the Hopper
# body, f32 the WMMA body
FWD_BODY = {torch.bfloat16: "sm90", torch.float32: "sm90"}
BODY = {torch.bfloat16: "sm90", torch.float32: "wmma"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("t,valid,band", TRAIN_ATTN_CASES)
def test_banded_attention_train_kernels_match_plain(cuda_device, t, valid, band, dtype):
    """Forward with LSE, dq and dk/dv kernels against the plain versions on
    the same bf16-rounded operands. Tolerances (of each output's max): o and
    the gradients 1e-2 (f32 sums in another order can flip one bf16
    rounding of P or dS, 2^-8 of a term; bf16 outputs are themselves rounded
    to 2^-8); the LSE 1e-3 absolute (f32 from the same operands)."""
    g = torch.Generator(device=cuda_device).manual_seed(t + band)
    n, h = 2, 3
    q, k, v = _qkv_heads(n, t, h, dtype, g, cuda_device)
    counts = (tba.banded_attention_fwd_lse.launches, tba.banded_attention_bwd_dq.launches,
              tba.banded_attention_bwd_dkv.launches)
    o, lse = tba.banded_attention_fwd_lse(q, k, v, band, valid)
    do = torch.randn((n, t, h, 64), generator=g, device=cuda_device).to(dtype).permute(0, 2, 1, 3)
    dq = tba.banded_attention_bwd_dq(q, k, v, o, lse, do, band, valid)
    dk, dv = tba.banded_attention_bwd_dkv(q, k, v, o, lse, do, band, valid)
    torch.cuda.synchronize()
    assert (tba.banded_attention_fwd_lse.launches, tba.banded_attention_bwd_dq.launches,
            tba.banded_attention_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    assert tba.banded_attention_fwd_lse.body == FWD_BODY[dtype]
    assert tba.banded_attention_bwd_dq.body == tba.banded_attention_bwd_dkv.body == BODY[dtype]
    want_o, want_lse = tba.banded_attention_fwd_lse_reference(q, k, v, band, valid, torch.bfloat16)
    want = tba.banded_attention_bwd_reference(q, k, v, o, lse, do, band, valid, torch.bfloat16)
    assert o.dtype == dq.dtype == dtype and lse.dtype == torch.float32
    assert _rel(o, want_o) <= 1e-2
    valid_rows = want_lse > -1e29  # rows with at least one valid key
    assert ((lse - want_lse).abs()[valid_rows].max().item()) <= 1e-3
    assert (lse[~valid_rows] < -1e29).all()
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.isfinite(got).all(), name
        assert _rel(got, w) <= 1e-2, name
    assert (dq[:, :, valid:] == 0).all() and (dk[:, :, valid:] == 0).all()


@pytest.mark.cuda
def test_banded_attention_function_on_card_matches_cpu(cuda_device):
    """The autograd Function under grad: one LSE forward, one dq and one
    dk/dv launch, no inference launch; outputs and gradients against the
    same Function on the CPU (plain versions), within 1e-2 of each max."""
    g = torch.Generator().manual_seed(3)
    n, h, t = 2, 2, 128
    base = [torch.randn(n, h, t, 64, generator=g).to(torch.bfloat16) for _ in range(4)]
    results = {}
    for dev in ("cpu", cuda_device):
        # fresh leaves on each device (.to("cpu") of a CPU tensor is the tensor itself)
        q, k, v = (a.detach().to(dev).requires_grad_() for a in base[:3])
        before = (tba.banded_attention.launches, tba.banded_attention_fwd_lse.launches,
                  tba.banded_attention_bwd_dq.launches, tba.banded_attention_bwd_dkv.launches)
        o = tba.banded_attention(q, k, v, t, 100)
        o.backward(base[3].to(dev))
        after = (tba.banded_attention.launches, tba.banded_attention_fwd_lse.launches,
                 tba.banded_attention_bwd_dq.launches, tba.banded_attention_bwd_dkv.launches)
        if dev != "cpu":
            assert tuple(b - a for a, b in zip(before, after)) == (0, 1, 1, 1)
        results[str(dev)] = [a.detach().cpu() for a in (o, q.grad, k.grad, v.grad)]
    for got, want in zip(results[str(cuda_device)], results["cpu"]):
        assert _rel(got, want) <= 1e-2


def _train_attention(q, k, v, do, band, valid):
    """(o, lse, dq, dk, dv) of the forward with LSE and the two backward kernels."""
    o, lse = tba.banded_attention_fwd_lse(q, k, v, band, valid)
    dq = tba.banded_attention_bwd_dq(q, k, v, o, lse, do, band, valid)
    dk, dv = tba.banded_attention_bwd_dkv(q, k, v, o, lse, do, band, valid)
    return o, lse, dq, dk, dv


@pytest.mark.cuda
@pytest.mark.parametrize("t,valid,band", [(128, 128, 128), (384, 380, 128)])
def test_banded_attention_train_kernels_odd_head_count(cuda_device, t, valid, band):
    """bf16 rows 2-4 at N = 3, H = 5 (15 (n, h) pairs, no multiple of any
    CTA count), held to the plain versions at the tolerances above."""
    g = torch.Generator(device=cuda_device).manual_seed(t + 5)
    n, h = 3, 5
    q, k, v = _qkv_heads(n, t, h, torch.bfloat16, g, cuda_device)
    do = torch.randn((n, t, h, 64), generator=g, device=cuda_device).to(torch.bfloat16).permute(0, 2, 1, 3)
    o, lse, dq, dk, dv = _train_attention(q, k, v, do, band, valid)
    assert (tba.banded_attention_fwd_lse.body == tba.banded_attention_bwd_dq.body
            == tba.banded_attention_bwd_dkv.body == "sm90")
    want_o, want_lse = tba.banded_attention_fwd_lse_reference(q, k, v, band, valid, torch.bfloat16)
    want = tba.banded_attention_bwd_reference(q, k, v, o, lse, do, band, valid, torch.bfloat16)
    assert _rel(o, want_o) <= 1e-2
    assert (lse - want_lse).abs().max().item() <= 1e-3
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.isfinite(got).all(), name
        assert _rel(got, w) <= 1e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,h,t,valid,band", [(256, 16, 128, 128, 128), (3, 5, 200, 190, 20),
                                              (3, 5, 384, 370, 128)])
def test_banded_attention_train_kernels_at_head_dim_72(cuda_device, n, h, t, valid, band, dtype):
    """Rows 2-4 at DiT-XL's head dim 72 (the XL training shape, a ragged T
    with valid_len < T and band < T, three 128-row blocks), Hopper bodies in
    bf16 and WMMA dq and dk/dv in f32, against the plain versions at the
    tolerances above."""
    g = torch.Generator(device=cuda_device).manual_seed(t + band + 72)
    q, k, v = _qkv_heads(n, t, h, dtype, g, cuda_device, dh=72)
    do = torch.randn((n, t, h, 72), generator=g, device=cuda_device).to(dtype).permute(0, 2, 1, 3)
    o, lse, dq, dk, dv = _train_attention(q, k, v, do, band, valid)
    torch.cuda.synchronize()
    assert tba.banded_attention_fwd_lse.body == FWD_BODY[dtype]
    assert tba.banded_attention_bwd_dq.body == tba.banded_attention_bwd_dkv.body == BODY[dtype]
    want_o, want_lse = tba.banded_attention_fwd_lse_reference(q, k, v, band, valid, torch.bfloat16)
    want = tba.banded_attention_bwd_reference(q, k, v, o, lse, do, band, valid, torch.bfloat16)
    assert o.shape == dq.shape == dk.shape == dv.shape == (n, h, t, 72)
    assert _rel(o, want_o) <= 1e-2
    keyed = want_lse > -1e29
    assert (lse - want_lse).abs()[keyed].max().item() <= 1e-3
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.isfinite(got).all(), name
        assert _rel(got, w) <= 1e-2, name
    assert (dq[:, :, valid:] == 0).all() and (dk[:, :, valid:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("ranged", [False, True], ids=["banded", "ranged"])
def test_banded_attention_persistent_ctas_walk_many_items(cuda_device, ranged):
    """More (n*h, block) items than CTAs fit on the card at once, so every
    persistent CTA of the bf16 bodies walks several items through its ring
    (and, ranged, past pad blocks that load nothing): rows 2 and 4 (5 and 6)
    against the plain versions at the tolerances above; dq (row 3, row 6's
    dq) the same way, 0 on pad query rows."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    if ranged:
        q, k, v, do, bounds = _ranged_inputs(24, 12, 256, 128, 1, 2, None, torch.bfloat16, g, cuda_device)
        o, lse = tba.banded_attention_ranged_fwd_lse(q, k, v, 128, bounds)
        dq = tba.banded_attention_ranged_bwd_dq(q, k, v, o, lse, do, 128, bounds)
        dk, dv = tba.banded_attention_ranged_bwd_dkv(q, k, v, o, lse, do, 128, bounds)
        assert not dq[:, :, :bounds[2]].any() and not dq[:, :, bounds[3]:].any()
        t = q.shape[2]
        want_o, want_lse = tba.banded_attention_fwd_lse_reference(q, k, v, 128, t, torch.bfloat16, bounds)
        want = tba.banded_attention_bwd_reference(q, k, v, o, lse, do, 128, t, torch.bfloat16, bounds)
        rows = slice(bounds[2], bounds[3])
        o, want_o = o[:, :, rows], want_o[:, :, rows]
        lse, want_lse = lse.view(24, 12, t)[:, :, rows], want_lse.view(24, 12, t)[:, :, rows]
    else:
        q, k, v = _qkv_heads(64, 256, 12, torch.bfloat16, g, cuda_device)
        do = torch.randn((64, 256, 12, 64), generator=g, device=cuda_device).to(torch.bfloat16).permute(0, 2, 1, 3)
        o, lse = tba.banded_attention_fwd_lse(q, k, v, 128, 250)
        dq = tba.banded_attention_bwd_dq(q, k, v, o, lse, do, 128, 250)
        dk, dv = tba.banded_attention_bwd_dkv(q, k, v, o, lse, do, 128, 250)
        want_o, want_lse = tba.banded_attention_fwd_lse_reference(q, k, v, 128, 250, torch.bfloat16)
        want = tba.banded_attention_bwd_reference(q, k, v, o, lse, do, 128, 250, torch.bfloat16)
    torch.cuda.synchronize()
    assert _rel(o, want_o) <= 1e-2
    assert (lse - want_lse).abs().max().item() <= 1e-3
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.isfinite(got).all(), name
        assert _rel(got, w) <= 1e-2, name


@pytest.mark.cuda
def test_banded_attention_bf16_layouts_agree(cuda_device):
    """The Hopper bodies read through strides: head views of a packed qkv
    projection and contiguous copies of the same values give the same bits
    (o, LSE, dq, dk, dv); so does a q/k/v whose strides TMA cannot take (a row
    stride of 68 elements, 136 bytes), which the wrapper copies to a
    contiguous layout first; and a `do` given contiguous (N, H, T, Dh)
    through the autograd Function, which copies it to the (N, T, H, Dh)
    layout the kernels read."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    n, h, t, band, valid = 2, 3, 200, 128, 190
    q, k, v = _qkv_heads(n, t, h, torch.bfloat16, g, cuda_device)
    do = torch.randn((n, t, h, 64), generator=g, device=cuda_device).to(torch.bfloat16).permute(0, 2, 1, 3)
    packed = _train_attention(q, k, v, do, band, valid)
    contiguous = _train_attention(q.contiguous(), k.contiguous(), v.contiguous(), do, band, valid)
    wide = [torch.zeros((n, h, t, 68), device=cuda_device, dtype=torch.bfloat16) for _ in range(3)]
    for w, a in zip(wide, (q, k, v)):
        w[..., :64] = a
    odd = [w[..., :64] for w in wide]
    assert odd[0].stride(2) == 68
    odd_strides = _train_attention(*odd, do, band, valid)
    assert (tba.banded_attention_fwd_lse.body == tba.banded_attention_bwd_dq.body
            == tba.banded_attention_bwd_dkv.body == "sm90")
    for name, a, b, c in zip(("o", "lse", "dq", "dk", "dv"), packed, contiguous, odd_strides):
        assert torch.equal(a, b), name
        assert torch.equal(a, c), name
    leaves = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    out = tba.banded_attention(*leaves, band, valid)
    out.backward(do.contiguous())  # (N, H, T, Dh) contiguous, not the kernels' layout
    assert torch.equal(out, packed[0])
    for name, leaf, want in zip(("dq", "dk", "dv"), leaves, packed[2:]):
        assert torch.equal(leaf.grad, want), name


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["dq", "dkv"])
@pytest.mark.parametrize("ranged", [False, True], ids=["banded", "ranged"])
def test_banded_attention_backward_is_bit_identical_run_to_run(cuda_device, ranged, entry):
    """No atomics: two dq (dk/dv) calls on the same bf16 inputs give the
    same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    if ranged:
        q, k, v, do, bounds = _ranged_inputs(4, 12, 256, 128, 0, 2, None, torch.bfloat16, g, cuda_device)
        o, lse = tba.banded_attention_ranged_fwd_lse(q, k, v, 128, bounds)
        fn = getattr(tba, f"banded_attention_ranged_bwd_{entry}")
        runs = [fn(q, k, v, o, lse, do, 128, bounds) for _ in range(2)]
    else:
        q, k, v = _qkv_heads(8, 128, 12, torch.bfloat16, g, cuda_device)
        do = torch.randn((8, 128, 12, 64), generator=g, device=cuda_device).to(torch.bfloat16).permute(0, 2, 1, 3)
        o, lse = tba.banded_attention_fwd_lse(q, k, v, 128, 128)
        fn = getattr(tba, f"banded_attention_bwd_{entry}")
        runs = [fn(q, k, v, o, lse, do, 128, 128) for _ in range(2)]
    torch.cuda.synchronize()
    assert fn.body == "sm90"
    first, second = ((r,) if entry == "dq" else r for r in runs)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert first[0].abs().max().item() > 0


def _ranged_inputs(n, h, t_loc, band, idx, p, valid, dtype, g, device, dh=64):
    """A shard's halo-extended (N, H, T_ext, dh) q, k, v (one contiguous
    layout, as parallel/context.py builds them), an upstream gradient in
    the kernels' output layout, and the shard's bounds."""
    halo = -(-band // 128) * 128
    bounds = shard_bounds(t_loc, halo, types.SimpleNamespace(model_rank=idx, num_model=p), valid)
    t_ext = t_loc + 2 * halo
    q, k, v = (torch.randn((n, h, t_ext, dh), generator=g, device=device).to(dtype) for _ in range(3))
    do = torch.randn((n, t_ext, h, dh), generator=g, device=device).to(dtype).permute(0, 2, 1, 3)
    return q, k, v, do, bounds


def test_ranged_wrappers_take_the_plain_versions_on_cpu():
    """A CPU tensor goes to the ranged plain versions and launches nothing;
    the ranged backward gives no gradient to pad query rows, nor to masked
    keys."""
    g = torch.Generator().manual_seed(1)
    q, k, v, do, bounds = _ranged_inputs(1, 2, 128, 96, 0, 2, None, torch.float32, g, "cpu")
    k_lo, k_hi, q_lo, q_hi = bounds
    wrappers = (tba.banded_attention_ranged, tba.banded_attention_ranged_fwd_lse,
                tba.banded_attention_ranged_bwd_dq, tba.banded_attention_ranged_bwd_dkv)
    before = [f.launches for f in wrappers]
    t = q.shape[2]
    o, lse = tba.banded_attention_ranged_fwd_lse(q, k, v, 96, bounds)
    want_o, want_lse = tba.banded_attention_fwd_lse_reference(q, k, v, 96, t, torch.bfloat16, bounds)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    assert torch.equal(tba.banded_attention_ranged(q, k, v, 96, bounds), want_o)
    dq = tba.banded_attention_ranged_bwd_dq(q, k, v, o, lse, do, 96, bounds)
    dk, dv = tba.banded_attention_ranged_bwd_dkv(q, k, v, o, lse, do, 96, bounds)
    want = tba.banded_attention_bwd_reference(q, k, v, o, lse, do, 96, t, torch.bfloat16, bounds)
    for got, w in zip((dq, dk, dv), want):
        assert torch.equal(got, w)
    assert not dq[:, :, :q_lo].any() and not dq[:, :, q_hi:].any() and dq[:, :, q_lo:q_hi].any()
    assert not dk[:, :, :k_lo].any() and not dv[:, :, :k_lo].any() and dk[:, :, k_lo:].any()
    assert [f.launches for f in wrappers] == before
    with pytest.raises(ValueError):  # q rows beyond T
        tba.banded_attention_ranged(q, k, v, 96, (k_lo, k_hi, q_lo, t + 1))


# (T_loc, band, shard index, shards, valid_len): the CP training shard's
# left and right edges (seq-len 512 over 2), an interior shard, a band
# below one tile, a halo of two blocks, the sampling tail inside a shard
RANGED_KERNEL_CASES = [(256, 128, 0, 2, None), (256, 128, 1, 2, None), (256, 96, 1, 3, None),
                       (128, 48, 0, 2, None), (256, 160, 1, 3, None), (384, 128, 1, 2, 757)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("t_loc,band,idx,p,valid", RANGED_KERNEL_CASES)
def test_banded_attention_ranged_kernels_match_plain(cuda_device, t_loc, band, idx, p, valid, dtype):
    """The four ranged entries against their plain versions on the same
    bf16-rounded operands, at the tolerances of the unranged kernels: o and
    the LSE on the rows [q_lo, q_hi), dq there (0 on the pad rows), dk and
    dv on every row (0 on masked keys); one launch of each wrapper."""
    _check_ranged_kernels(cuda_device, t_loc, band, idx, p, valid, dtype, dh=64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("t_loc,band,idx,p,valid", [(256, 128, 0, 2, None), (256, 128, 1, 2, None),
                                                    (256, 96, 1, 3, None), (384, 128, 1, 2, 757)])
def test_banded_attention_ranged_kernels_at_head_dim_72(cuda_device, t_loc, band, idx, p, valid, dtype):
    """The same at DiT-XL's head dim 72 (XL under context parallelism): the
    CP training shard's two edges, an interior shard and a tail inside a
    shard."""
    _check_ranged_kernels(cuda_device, t_loc, band, idx, p, valid, dtype, dh=72)


def _check_ranged_kernels(cuda_device, t_loc, band, idx, p, valid, dtype, dh):
    g = torch.Generator(device=cuda_device).manual_seed(t_loc + band + idx + (dh != 64) * dh)
    q, k, v, do, bounds = _ranged_inputs(2, 3, t_loc, band, idx, p, valid, dtype, g, cuda_device, dh)
    k_lo, k_hi, q_lo, q_hi = bounds
    wrappers = (tba.banded_attention_ranged, tba.banded_attention_ranged_fwd_lse,
                tba.banded_attention_ranged_bwd_dq, tba.banded_attention_ranged_bwd_dkv)
    counts = [f.launches for f in wrappers]
    o_inf = tba.banded_attention_ranged(q, k, v, band, bounds)
    o, lse = tba.banded_attention_ranged_fwd_lse(q, k, v, band, bounds)
    dq = tba.banded_attention_ranged_bwd_dq(q, k, v, o, lse, do, band, bounds)
    dk, dv = tba.banded_attention_ranged_bwd_dkv(q, k, v, o, lse, do, band, bounds)
    torch.cuda.synchronize()
    assert [f.launches for f in wrappers] == [c + 1 for c in counts]
    assert tba.banded_attention_ranged.body == tba.banded_attention_ranged_fwd_lse.body == FWD_BODY[dtype]
    assert tba.banded_attention_ranged_bwd_dq.body == tba.banded_attention_ranged_bwd_dkv.body == BODY[dtype]
    t = q.shape[2]
    want_o, want_lse = tba.banded_attention_fwd_lse_reference(q, k, v, band, t, torch.bfloat16, bounds)
    want = tba.banded_attention_bwd_reference(q, k, v, o, lse, do, band, t, torch.bfloat16, bounds)
    rows = slice(q_lo, q_hi)
    assert torch.equal(o_inf[:, :, rows], o[:, :, rows])
    assert _rel(o[:, :, rows], want_o[:, :, rows]) <= 1e-2
    has_key = want_lse.view(2, 3, t)[:, :, rows] > -1e29
    got_lse = lse.view(2, 3, t)[:, :, rows]
    assert (got_lse - want_lse.view(2, 3, t)[:, :, rows]).abs()[has_key].max().item() <= 1e-3
    assert (got_lse[~has_key] < -1e29).all()
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert torch.isfinite(got).all(), name
        assert _rel(got, w) <= 1e-2, name
    assert not dq[:, :, :q_lo].any() and not dq[:, :, q_hi:].any()
    assert not dk[:, :, :k_lo].any() and not dv[:, :, max(k_lo, k_hi):].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,t,d", [(4, 128, 768), (3, 50, 768), (2, 100, 384), (2, 757, 1024),
                                   (4, 128, 1152), (3, 50, 1152)])
def test_adaln_mlp_train_kernel_matches_plain(cuda_device, n, t, d, dtype):
    """The training forward's out, a and mlp against the plain version on
    the same bf16 operands, within 1e-2 of each max (a bf16 rounding flip of
    the hidden activation moves mlp by 2^-8 of a term; bf16 out and a are
    themselves rounded to 2^-8); the Hopper body, the same bits on a second
    call, and the inference forward's out bit-equal to the training one's."""
    g = torch.Generator(device=cuda_device).manual_seed(d + t)

    def rnd(*shape, std):
        return torch.randn(shape, generator=g, device=cuda_device) * std

    x, mod = rnd(n, t, d, std=1.0).to(dtype), rnd(n, 6 * d, std=0.3)
    shift, scale, gate = mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:]
    w1 = rnd(d, 4 * d, std=d ** -0.5).to(torch.bfloat16)
    w2 = rnd(4 * d, d, std=(4 * d) ** -0.5).to(torch.bfloat16)
    b1, b2 = rnd(4 * d, std=0.02), rnd(d, std=0.02)
    fc1_w, fc2_w = w1.t().contiguous(), w2.t().contiguous()
    before = tam.adaln_mlp_train.launches
    out, a, mlp = tam.adaln_mlp_train(x, shift, scale, gate, fc1_w, b1, fc2_w, b2)
    torch.cuda.synchronize()
    assert tam.adaln_mlp_train.launches == before + 1
    assert tam.adaln_mlp_train.body == "sm90"
    want = tam.adaln_mlp_train_reference(x, shift, scale, gate, w1, b1, w2, b2, 1e-6, torch.bfloat16)
    assert out.dtype == a.dtype == dtype and mlp.dtype == torch.float32
    assert a.shape == (n, t, 4 * d) and mlp.shape == (n, t, d)
    for name, got, w in zip(("out", "a", "mlp"), (out, a, mlp), want):
        assert _rel(got, w) <= 1e-2, name
    again = tam.adaln_mlp_train(x, shift, scale, gate, fc1_w, b1, fc2_w, b2)
    assert all(torch.equal(u, v) for u, v in zip(again, (out, a, mlp)))
    # the inference kernel gives the training forward's out
    assert torch.equal(tam.adaln_mlp(x, shift, scale, gate, fc1_w, b1, fc2_w, b2), out)


@pytest.mark.cuda
def test_adaln_mlp_function_on_card_matches_cpu(cuda_device):
    """AdalnMlp under grad on the card (kernel forward, f32-result bf16
    matmuls in the backward) against the CPU Function: the output and all
    eight gradients within 1e-2 of each max."""
    g = torch.Generator().manual_seed(4)
    n, t, d = 2, 64, 384
    x = torch.randn(n, t, d, generator=g).to(torch.bfloat16)
    mods = [torch.randn(n, d, generator=g) * 0.3 for _ in range(3)]
    fc1_w, fc2_w = torch.randn(4 * d, d, generator=g) * d ** -0.5, torch.randn(d, 4 * d, generator=g) * (4 * d) ** -0.5
    b1, b2 = torch.randn(4 * d, generator=g) * 0.02, torch.randn(d, generator=g) * 0.02
    gout = torch.randn(n, t, d, generator=g).to(torch.bfloat16)
    results = {}
    for dev in ("cpu", cuda_device):
        ins = [a.detach().to(dev).requires_grad_() for a in (x, *mods, fc1_w, b1, fc2_w, b2)]
        out = tam.AdalnMlp.apply(*ins, 1e-6, torch.bfloat16)
        out.backward(gout.to(dev))
        results[str(dev)] = [out.detach().cpu()] + [a.grad.cpu() for a in ins]
    for got, want in zip(results[str(cuda_device)], results["cpu"]):
        assert _rel(got, want) <= 1e-2


def _bwd_inputs(n, t, d, dtype, g, device):
    """The fused backward's inputs at a seeded forward: (x, shift, scale,
    gate (row views of one modulation tensor), w1, w2 (bf16), a, mlp (the
    training forward's residuals on the card), upstream gradient)."""
    def rnd(*shape, std):
        return torch.randn(shape, generator=g, device=device) * std

    x, mod = rnd(n, t, d, std=1.0).to(dtype), rnd(n, 6 * d, std=0.3)
    shift, scale, gate = mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:]
    w1 = rnd(d, 4 * d, std=d ** -0.5).to(torch.bfloat16)
    w2 = rnd(4 * d, d, std=(4 * d) ** -0.5).to(torch.bfloat16)
    b1, b2 = rnd(4 * d, std=0.02), rnd(d, std=0.02)
    _, a, mlp = tam.adaln_mlp_train_reference(x, shift, scale, gate, w1, b1, w2, b2, 1e-6,
                                              torch.bfloat16)
    return x, shift, scale, gate, w1, w2, a, mlp, rnd(n, t, d, std=1.0).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,t,d", [(4, 128, 768), (3, 50, 768), (2, 100, 384), (1, 40, 1024),
                                   (2, 757, 1024), (4, 128, 1152), (3, 50, 1152)])
def test_adaln_mlp_bwd_kernels_match_plain(cuda_device, n, t, d, dtype):
    """The fused backward's two stages against their plain versions on the
    same bf16 operands, each output within 1e-2 of its max (the reasons of
    test_adaln_mlp_train_kernel_matches_plain: a bf16 rounding flip of dmlp
    or da moves a sum by 2^-8 of a term, and stream-type outputs are
    themselves rounded to 2^-8); the weights in torch's layout; each wrapper
    launches once, runs the stream's body (bf16: the Hopper body, f32: the
    WMMA body) and gives the same bits on a second call."""
    g = torch.Generator(device=cuda_device).manual_seed(n + t + d)
    x, shift, scale, gate, w1, w2, a, mlp, gout = _bwd_inputs(n, t, d, dtype, g, cuda_device)
    fc1_w, fc2_w = w1.t().contiguous(), w2.t().contiguous()
    counts = (tam.adaln_mlp_bwd_prologue.launches, tam.adaln_mlp_bwd_epilogue.launches)
    got = tam.adaln_mlp_bwd_prologue(gout, mlp, a, gate, fc2_w)
    torch.cuda.synchronize()
    assert tam.adaln_mlp_bwd_prologue.body == BODY[dtype]
    assert all(torch.equal(u, v) for u, v in zip(tam.adaln_mlp_bwd_prologue(gout, mlp, a, gate, fc2_w), got))
    want = tam.adaln_mlp_bwd_prologue_reference(gout, mlp, a, gate, w2, torch.bfloat16)
    for name, u, v in zip(("da", "gelu_out", "dmlp", "dgate", "db1", "db2"), got, want):
        assert u.dtype == v.dtype and u.shape == v.shape, name
        assert torch.isfinite(u).all(), name
        assert _rel(u, v) <= 1e-2, (name, _rel(u, v))
    da = want[0]  # the epilogue on the plain prologue's da: each stage alone
    got = tam.adaln_mlp_bwd_epilogue(da, x, gout, shift, scale, fc1_w)
    torch.cuda.synchronize()
    assert tam.adaln_mlp_bwd_epilogue.body == BODY[dtype]
    assert all(torch.equal(u, v) for u, v in zip(tam.adaln_mlp_bwd_epilogue(da, x, gout, shift, scale, fc1_w), got))
    want = tam.adaln_mlp_bwd_epilogue_reference(da, x, gout, shift, scale, w1, 1e-6, torch.bfloat16)
    for name, u, v in zip(("dx", "h1", "dshift", "dscale"), got, want):
        assert u.dtype == v.dtype and u.shape == v.shape, name
        assert torch.isfinite(u).all(), name
        assert _rel(u, v) <= 1e-2, (name, _rel(u, v))
    assert (tam.adaln_mlp_bwd_prologue.launches, tam.adaln_mlp_bwd_epilogue.launches) == \
        tuple(c + 2 for c in counts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n,t,d,p", [(4, 128, 768, 2), (3, 50, 768, 4), (2, 100, 1152, 4)])
def test_adaln_mlp_partial_kernels_at_shard_widths(cuda_device, n, t, d, p, dtype):
    """Rows 8 and 9b on each tensor-parallel rank's hidden units (H = 4D/P),
    the first rank whole and the others `partial` (no b2, no residual x in
    the forward, no residual g in dx), against their plain versions on the
    same shard within 1e-2 of each max (test_adaln_mlp_train_kernel_matches_plain's
    reasons); the ranks' out summed within 2e-2 of the whole MLP half's
    plain out (P bf16 roundings of out instead of one)."""
    g = torch.Generator(device=cuda_device).manual_seed(n + t + d + p)
    x, shift, scale, gate, w1, w2, _, _, gout = _bwd_inputs(n, t, d, dtype, g, cuda_device)
    b1 = torch.randn(4 * d, generator=g, device=cuda_device) * 0.02
    b2 = torch.randn(d, generator=g, device=cuda_device) * 0.02
    hs = 4 * d // p
    total = torch.zeros(n, t, d, device=cuda_device)
    for r in range(p):
        cols = slice(r * hs, (r + 1) * hs)
        partial = r > 0
        fc1_w, fc2_w, b1r = w1[:, cols].t().contiguous(), w2[cols].t().contiguous(), b1[cols].contiguous()
        got = tam.adaln_mlp_train(x, shift, scale, gate, fc1_w, b1r, fc2_w, b2, partial=partial)
        want = tam.adaln_mlp_train_reference(x, shift, scale, gate, w1[:, cols], b1r, w2[cols], b2, 1e-6,
                                             torch.bfloat16, partial)
        for name, u, v in zip(("out", "a", "mlp"), got, want):
            assert _rel(u, v) <= 1e-2, (r, name, _rel(u, v))
        total += got[0].float()
        da = torch.randn(n, t, hs, generator=g, device=cuda_device).to(dtype)
        epi = tam.adaln_mlp_bwd_epilogue(da, x, gout, shift, scale, fc1_w, partial=partial)
        want = tam.adaln_mlp_bwd_epilogue_reference(da, x, gout, shift, scale, w1[:, cols], 1e-6,
                                                    torch.bfloat16, partial)
        for name, u, v in zip(("dx", "h1", "dshift", "dscale"), epi, want):
            assert _rel(u, v) <= 1e-2, (r, name, _rel(u, v))
    whole = tam.adaln_mlp_train_reference(x, shift, scale, gate, w1, b1, w2, b2, 1e-6, torch.bfloat16)[0]
    assert _rel(total, whole) <= 2e-2


@pytest.mark.cuda
def test_adaln_mlp_fused_bf16_packs_no_weights(cuda_device, monkeypatch):
    """Under the fused backward with a bf16 stream, a training step's
    forward and backward read the weights in torch's layout: nothing
    packs them."""
    def refuse(*args, **kwargs):
        raise AssertionError("packed weights on the bf16 path")

    for name in ("pack_weights", "pack_w1", "pack_w2"):
        monkeypatch.setattr(tam, name, refuse)
    g = torch.Generator().manual_seed(6)
    n, t, d = 2, 64, 384
    ins = [torch.randn(n, t, d, generator=g).to(torch.bfloat16)]
    ins += [torch.randn(n, d, generator=g) * 0.3 for _ in range(3)]
    ins += [torch.randn(4 * d, d, generator=g) * d ** -0.5, torch.randn(4 * d, generator=g) * 0.02,
            torch.randn(d, 4 * d, generator=g) * (4 * d) ** -0.5, torch.randn(d, generator=g) * 0.02]
    ins = [a.to(cuda_device).requires_grad_() for a in ins]
    counts = (tam.adaln_mlp_bwd_prologue.launches, tam.adaln_mlp_bwd_epilogue.launches)
    out = tam.AdalnMlp.apply(*ins, 1e-6, torch.bfloat16, "fused")
    out.backward(torch.ones_like(out))
    torch.cuda.synchronize()
    assert (tam.adaln_mlp_bwd_prologue.launches, tam.adaln_mlp_bwd_epilogue.launches) == \
        tuple(c + 1 for c in counts)
    assert tam.adaln_mlp_bwd_prologue.body == tam.adaln_mlp_bwd_epilogue.body == "sm90"
    assert all(torch.isfinite(a.grad).all() for a in ins)


@pytest.mark.cuda
def test_adaln_mlp_fused_function_on_card_matches_cpu(cuda_device):
    """AdalnMlp(bwd_impl="fused") under grad on the card (kernel forward,
    both backward kernels, cuBLAS weight gradients) against the CPU
    Function: the output and all eight gradients within 1e-2 of each max;
    one launch of each backward kernel, none on the CPU."""
    g = torch.Generator().manual_seed(5)
    n, t, d = 2, 64, 384
    x = torch.randn(n, t, d, generator=g).to(torch.bfloat16)
    mods = [torch.randn(n, d, generator=g) * 0.3 for _ in range(3)]
    fc1_w, fc2_w = torch.randn(4 * d, d, generator=g) * d ** -0.5, torch.randn(d, 4 * d, generator=g) * (4 * d) ** -0.5
    b1, b2 = torch.randn(4 * d, generator=g) * 0.02, torch.randn(d, generator=g) * 0.02
    gout = torch.randn(n, t, d, generator=g).to(torch.bfloat16)
    results = {}
    for dev in ("cpu", cuda_device):
        counts = (tam.adaln_mlp_bwd_prologue.launches, tam.adaln_mlp_bwd_epilogue.launches)
        ins = [a.detach().to(dev).requires_grad_() for a in (x, *mods, fc1_w, b1, fc2_w, b2)]
        out = tam.AdalnMlp.apply(*ins, 1e-6, torch.bfloat16, "fused")
        out.backward(gout.to(dev))
        launched = tuple(b - a for a, b in zip(counts, (tam.adaln_mlp_bwd_prologue.launches,
                                                         tam.adaln_mlp_bwd_epilogue.launches)))
        assert launched == ((0, 0) if dev == "cpu" else (1, 1))
        results[str(dev)] = [out.detach().cpu()] + [a.grad.cpu() for a in ins]
    for got, want in zip(results[str(cuda_device)], results["cpu"]):
        assert _rel(got, want) <= 1e-2


@pytest.mark.cuda
def test_adaln_mlp_bwd_kernels_reject_what_they_do_not_take(cuda_device):
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(0)
    x, shift, scale, gate, w1, w2, a, mlp, gout = _bwd_inputs(2, 8, 384, torch.float32, g, dev)
    fc1_w, fc2_w = w1.t().contiguous(), w2.t().contiguous()
    with pytest.raises(ValueError):  # f32 operands have no kernel
        tam.adaln_mlp_bwd_prologue(gout, mlp, a, gate, fc2_w, torch.float32)
    with pytest.raises(TypeError):  # a in another type than the stream
        tam.adaln_mlp_bwd_prologue(gout, mlp, a.to(torch.bfloat16), gate, fc2_w)
    with pytest.raises(ValueError):  # fc1's weight not in torch's (H, D) layout
        tam.adaln_mlp_bwd_epilogue(a, x, gout, shift, scale, w1)
    with pytest.raises(ValueError):  # a weight that is not contiguous
        tam.adaln_mlp_bwd_prologue(gout, mlp, a, gate, w2.t())
    with pytest.raises(ValueError):  # shift and scale with different strides
        tam.adaln_mlp_bwd_epilogue(a, x, gout, shift.contiguous(), scale, fc1_w)


# ---------------------------------------------------------------------------
# int8 weight-only serving: rows 10-13
# ---------------------------------------------------------------------------

# max |kernel - plain| / max |plain|. Against the plain version with the
# same bf16 operands and int8 codes: f32 sums in another order (~1e-6), and
# where a LayerNorm or GELU comes first, an ulp-level difference that flips
# one bf16 rounding of an operand (2^-8 of one term). Against the f32
# dequantised plain version: bf16 rounding of the activations (2^-9
# relative) over K-term sums.
QUANT_TOL_BF16 = 2e-3
QUANT_TOL_F32 = 1e-2


def _quant_weight(m, k, g, device):
    """Seeded (M, K) f32 weight of unit-variance outputs: (codes, scale)."""
    return tq.quantize_weight(torch.randn((m, k), generator=g, device=device) * k ** -0.5)


def test_quant_wrappers_take_the_plain_versions_on_cpu():
    """CPU tensors go to the plain versions (bf16 operands) and launch
    nothing."""
    g = torch.Generator().manual_seed(5)
    n, t, d = 2, 10, 64
    x, res = torch.randn(n, t, d, generator=g), torch.randn(n, t, d, generator=g)
    mod = torch.randn(n, 6 * d, generator=g) * 0.3
    wq, s = _quant_weight(3 * d, d, g, "cpu")
    b = torch.randn(3 * d, generator=g) * 0.02
    counts = [f.launches for f in (tq.int8_matmul, tq.int8_modulated_matmul,
                                   tq.int8_out_residual, tam.adaln_mlp_quant)]
    assert torch.equal(tq.int8_matmul(x, wq, s, b, "gelu_tanh"),
                       tq.int8_matmul_reference(x, wq, s, b, "gelu_tanh", torch.bfloat16))
    assert torch.equal(tq.int8_modulated_matmul(x, mod[:, :d], mod[:, d:2 * d], wq, s, b),
                       tq.int8_modulated_matmul_reference(x, mod[:, :d], mod[:, d:2 * d], wq, s, b,
                                                          1e-6, torch.bfloat16))
    wo, so = _quant_weight(d, d, g, "cpu")
    assert torch.equal(tq.int8_out_residual(x, res, mod[:, 2 * d:3 * d], wo, so, b[:d]),
                       tq.int8_out_residual_reference(x, res, mod[:, 2 * d:3 * d], wo, so, b[:d],
                                                      torch.bfloat16))
    w1q, s1 = _quant_weight(4 * d, d, g, "cpu")
    w2q, s2 = _quant_weight(d, 4 * d, g, "cpu")
    b1 = torch.zeros(4 * d)
    got = tam.adaln_mlp_quant(x, mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:],
                              w1q, s1, b1, w2q, s2, b[:d])
    want = tam.adaln_mlp_quant_reference(x, mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d],
                                         mod[:, 5 * d:], w1q.t(), s1, b1, w2q.t(), s2, b[:d],
                                         1e-6, torch.bfloat16)
    assert torch.equal(got, want)
    assert counts == [f.launches for f in (tq.int8_matmul, tq.int8_modulated_matmul,
                                           tq.int8_out_residual, tam.adaln_mlp_quant)]


def _check_quant(got, plain, *args, **kwargs):
    want16 = plain(*args, **kwargs, matmul_dtype=torch.bfloat16)
    want32 = plain(*args, **kwargs, matmul_dtype=torch.float32)
    assert got.shape == want16.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _rel(got, want16) <= QUANT_TOL_BF16, _rel(got, want16)
    assert _rel(got, want32) <= QUANT_TOL_F32, _rel(got, want32)


@pytest.mark.cuda
@pytest.mark.parametrize("lead,k,m,act", [
    ((2,), 768, 4608, None),          # the DiT-B adaLN projection: the skinny body
    ((1,), 768, 4608, None),          # one row
    ((3, 37), 768, 2304, None),       # lead dims, 111 rows: the wide body
    ((100,), 64, 96, "gelu_tanh"),    # M not a multiple of 64, GELU
    ((8, 128), 1024, 1000, "gelu_tanh"),
    ((16,), 768, 4608, "gelu_tanh"),  # two n8 tiles, 64-column CTAs
    ((64,), 768, 4608, None),         # 64 rows: two 32-row blocks
    ((96,), 768, 4608, None),         # SKINNY_ROWS
    ((256,), 768, 4608, None),
    ((2,), 1152, 6912, None),         # the DiT-XL adaLN projection
    ((1,), 1024, 1000, None),         # 63 column slabs
    ((3,), 256, 97, "gelu_tanh"),     # odd M, 32-column CTAs
    ((70,), 128, 33, None),           # odd M: five 16-row blocks
    ((2,), 2048, 5, None),            # M below a CTA's width, the deepest K
])
def test_int8_matmul_kernel_matches_plain(cuda_device, lead, k, m, act):
    """The body `adaln_plan` names, one launch counted, the same bits on a
    second call (no atomics: the partial sums meet in a fixed order)."""
    g = torch.Generator(device=cuda_device).manual_seed(k + m)
    x = torch.randn((*lead, k), generator=g, device=cuda_device)
    wq, s = _quant_weight(m, k, g, cuda_device)
    b = torch.randn(m, generator=g, device=cuda_device) * 0.02
    before = tq.int8_matmul.launches
    got = tq.int8_matmul(x, wq, s, b, act)
    torch.cuda.synchronize()
    assert tq.int8_matmul.launches == before + 1
    plan = tq.adaln_plan(x.numel() // k, k, m, torch.cuda.get_device_properties(0).multi_processor_count)
    assert tq.int8_matmul.body == plan.body
    _check_quant(got, tq.int8_matmul_reference, x, wq, s, b, act)
    assert torch.equal(tq.int8_matmul(x, wq, s, b, act), got)


@pytest.mark.cuda
@pytest.mark.parametrize("cw", [16, 32, 64])
@pytest.mark.parametrize("rows", [5, 40, 64])
def test_int8_matmul_skinny_widths_match_plain(cuda_device, cw, rows):
    """Every CTA width the skinny body takes, at 5, 40 and 64 rows (one row
    block of one n8 tile, then the plan's row blocks) and an odd M, against
    the plain version; the same bits on a second call."""
    g = torch.Generator(device=cuda_device).manual_seed(cw + rows)
    k, m = 768, 999
    x = torch.randn((rows, k), generator=g, device=cuda_device)
    wq, s = _quant_weight(m, k, g, cuda_device)
    b = torch.randn(m, generator=g, device=cuda_device) * 0.02
    plan = tq.adaln_plan(rows, k, m, 132, cw=cw)
    got = tq._adaln_launch(x, wq, s, b, "gelu_tanh", plan)
    torch.cuda.synchronize()
    assert tq.int8_matmul.body == "sm90_skinny"
    assert tq._lib().int8_matmul_skinny_smem_bytes(k, cw, plan.row_block) == plan.smem_bytes
    _check_quant(got, tq.int8_matmul_reference, x, wq, s, b, "gelu_tanh")
    assert torch.equal(tq._adaln_launch(x, wq, s, b, "gelu_tanh", plan), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,d,m", [(2, 768, 768, 2304), (2, 757, 768, 2304), (3, 50, 768, 2304),
                                     (8, 128, 384, 1152), (6, 128, 1024, 3072),
                                     (2, 40, 768, 1000)])
def test_int8_modulated_matmul_kernel_matches_plain(cuda_device, n, t, d, m):
    g = torch.Generator(device=cuda_device).manual_seed(n * t + m)
    x = torch.randn((n, t, d), generator=g, device=cuda_device)
    mod = torch.randn((n, 6 * d), generator=g, device=cuda_device) * 0.3
    wq, s = _quant_weight(m, d, g, cuda_device)
    b = torch.randn(m, generator=g, device=cuda_device) * 0.02
    before = tq.int8_modulated_matmul.launches
    got = tq.int8_modulated_matmul(x, mod[:, :d], mod[:, d:2 * d], wq, s, b)
    torch.cuda.synchronize()
    assert tq.int8_modulated_matmul.launches == before + 1
    assert tq.int8_modulated_matmul.body == "sm90"  # kernel B's modulate pass and Hopper GEMM
    _check_quant(got, tq.int8_modulated_matmul_reference, x, mod[:, :d], mod[:, d:2 * d], wq, s, b)
    assert torch.equal(tq.int8_modulated_matmul(x, mod[:, :d], mod[:, d:2 * d], wq, s, b), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,d", [(2, 768, 768), (3, 50, 768), (8, 128, 384), (6, 128, 1024)])
def test_int8_out_residual_kernel_matches_plain(cuda_device, n, t, d):
    """Row 12 on the Hopper GEMM over int8 codes, o in bf16 (as the banded
    attention writes it for the int8 block) and in f32 (rounded to a bf16
    copy first): the same bits either way and on a second call."""
    g = torch.Generator(device=cuda_device).manual_seed(n * t + d)
    o, res = (torch.randn((n, t, d), generator=g, device=cuda_device) for _ in range(2))
    gate = torch.randn((n, 6 * d), generator=g, device=cuda_device)[:, 2 * d:3 * d] * 0.3
    wq, s = _quant_weight(d, d, g, cuda_device)
    b = torch.randn(d, generator=g, device=cuda_device) * 0.02
    o16 = o.to(torch.bfloat16)
    before = (tq.int8_out_residual.launches, tq.int8_out_residual.o_casts)
    got = tq.int8_out_residual(o16, res, gate, wq, s, b)
    torch.cuda.synchronize()
    assert (tq.int8_out_residual.launches, tq.int8_out_residual.o_casts) == (before[0] + 1, before[1])
    assert tq.int8_out_residual.body == "sm90"  # kernel B's Hopper GEMM over int8 codes
    _check_quant(got, tq.int8_out_residual_reference, o, res, gate, wq, s, b)
    assert torch.equal(tq.int8_out_residual(o16, res, gate, wq, s, b), got)
    assert torch.equal(tq.int8_out_residual(o, res, gate, wq, s, b), got)
    assert tq.int8_out_residual.o_casts == before[1] + 1  # the f32 o's stated copy


@pytest.mark.cuda
def test_int8_out_residual_allocates_no_f32_o(cuda_device):
    """Row 12 reads the bf16 o as it is: at the DiT-B sampling shape one
    call allocates its f32 output (4.7 MB) and nothing of o's size in f32."""
    g = torch.Generator(device=cuda_device).manual_seed(10)
    n, t, d = 2, 768, 768
    o = torch.randn((n, t, d), generator=g, device=cuda_device).to(torch.bfloat16)
    res = torch.randn((n, t, d), generator=g, device=cuda_device)
    gate = torch.randn((n, d), generator=g, device=cuda_device) * 0.3
    wq, s = _quant_weight(d, d, g, cuda_device)
    b = torch.zeros(d, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    tq.int8_out_residual(o, res, gate, wq, s, b)
    torch.cuda.synchronize()
    f32_o = n * t * d * 4
    assert torch.cuda.max_memory_allocated(cuda_device) - base < f32_o + f32_o // 4


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,d", [(2, 768, 768), (2, 757, 768), (3, 50, 768), (8, 128, 384),
                                   (6, 128, 1024)])
def test_adaln_mlp_quant_kernel_matches_plain(cuda_device, n, t, d):
    g = torch.Generator(device=cuda_device).manual_seed(n * t + d)
    x = torch.randn((n, t, d), generator=g, device=cuda_device)
    mod = torch.randn((n, 6 * d), generator=g, device=cuda_device) * 0.3
    shift, scale, gate = mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:]
    w1q, s1 = _quant_weight(4 * d, d, g, cuda_device)
    w2q, s2 = _quant_weight(d, 4 * d, g, cuda_device)
    b1, b2 = (torch.randn(k, generator=g, device=cuda_device) * 0.02 for k in (4 * d, d))
    before = tam.adaln_mlp_quant.launches
    got = tam.adaln_mlp_quant(x, shift, scale, gate, w1q, s1, b1, w2q, s2, b2)
    torch.cuda.synchronize()
    assert tam.adaln_mlp_quant.launches == before + 1
    assert tam.adaln_mlp_quant.body == "sm90"  # int8 codes take the Hopper body
    _check_quant(got, tam.adaln_mlp_quant_reference, x, shift, scale, gate, w1q.t(), s1, b1,
                 w2q.t(), s2, b2)
    # one CTA owns each output tile: the same bits on a second call
    assert torch.equal(tam.adaln_mlp_quant(x, shift, scale, gate, w1q, s1, b1, w2q, s2, b2), got)


@pytest.mark.cuda
def test_int8_kernels_allocate_no_bf16_weight_copy(cuda_device):
    """Rows 10 and 11 read the int8 codes as they are: at 16 token rows one
    call allocates its activations (tens of KB), never a weight's worth of
    bf16 (fc1 at D = 768: 4.7 MB)."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    n, t, d = 1, 16, 768
    x = torch.randn((n, t, d), generator=g, device=cuda_device)
    mod = torch.randn((n, 6 * d), generator=g, device=cuda_device) * 0.3
    (w1q, s1), (w2q, s2), (wq, s) = (_quant_weight(m, k, g, cuda_device)
                                     for m, k in ((4 * d, d), (d, 4 * d), (3 * d, d)))
    b1, b2, b = (torch.zeros(k, device=cuda_device) for k in (4 * d, d, 3 * d))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    tam.adaln_mlp_quant(x, mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:], w1q, s1, b1, w2q,
                        s2, b2)
    tq.int8_modulated_matmul(x, mod[:, :d], mod[:, d:2 * d], wq, s, b)
    torch.cuda.synchronize()
    bf16_fc1 = 4 * d * d * 2
    assert torch.cuda.max_memory_allocated(cuda_device) - base < bf16_fc1 // 8


@pytest.mark.cuda
def test_quant_kernels_reject_what_they_do_not_take(cuda_device):
    dev = cuda_device
    x = torch.randn(4, 100, device=dev)  # K = 100: not a multiple of 64
    wq = torch.zeros(64, 100, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        tq.int8_matmul(x, wq, torch.ones(64, device=dev), torch.zeros(64, device=dev))
    x = torch.randn(1, 8, 2048, device=dev)  # the modulate pass takes D in SERVE_WIDTHS
    wq = torch.zeros(64, 2048, dtype=torch.int8, device=dev)
    m = torch.zeros(1, 2048, device=dev)
    with pytest.raises(ValueError):
        tq.int8_modulated_matmul(x, m, m, wq, torch.ones(64, device=dev), torch.zeros(64, device=dev))
    with pytest.raises(TypeError):  # the serving stream is f32
        tq.int8_matmul(x.to(torch.bfloat16), wq, torch.ones(64, device=dev), torch.zeros(64, device=dev))
    x = torch.randn(1, 8, 384, device=dev)  # the qkv epilogue stores column pairs: M even
    wq = torch.zeros(63, 384, dtype=torch.int8, device=dev)
    m = torch.zeros(1, 384, device=dev)
    with pytest.raises(ValueError):
        tq.int8_modulated_matmul(x, m, m, wq, torch.ones(63, device=dev), torch.zeros(63, device=dev))
    x = torch.randn(1, 8, 64, device=dev)  # D = 64 has no MLP kernel
    w1q = torch.zeros(256, 64, dtype=torch.int8, device=dev)
    w2q = torch.zeros(64, 256, dtype=torch.int8, device=dev)
    m = torch.zeros(1, 64, device=dev)
    with pytest.raises(ValueError):
        tam.adaln_mlp_quant(x, m, m, m, w1q, torch.ones(256, device=dev), torch.zeros(256, device=dev),
                            w2q, m[0] + 1, m[0])
    o = torch.zeros(1, 8, 192, device=dev, dtype=torch.bfloat16)  # no tile width divides D = 192
    res, gate = torch.zeros(1, 8, 192, device=dev), torch.zeros(1, 192, device=dev)
    wq = torch.zeros(192, 192, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        tq.int8_out_residual(o, res, gate, wq, torch.ones(192, device=dev), torch.zeros(192, device=dev))
    with pytest.raises(TypeError):  # o in another type than f32 or bf16
        tq.int8_out_residual(o.half(), res, gate, wq, torch.ones(192, device=dev), torch.zeros(192, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_banded_attention_reads_valid_len_on_the_device(cuda_device, dtype):
    """valid_len as a 0-d int32 CUDA tensor (read by the kernel, as a CUDA
    graph passes it): the int form's bits, one launch each; a training
    entry refuses it (it needs the int on the host)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = _qkv_heads(2, 768, 3, dtype, g, cuda_device)
    for valid in (757, 700, 768):
        valid_dev = torch.tensor(valid, dtype=torch.int32, device=cuda_device)
        before = tba.banded_attention.launches
        got = tba.banded_attention(q, k, v, 128, valid_dev)
        assert tba.banded_attention.launches == before + 1
        assert torch.equal(got, tba.banded_attention(q, k, v, 128, valid))
    with pytest.raises(ValueError):
        tba.banded_attention_fwd_lse(q, k, v, 128, valid_dev)


def _small_dit(device, steps):
    """A DiT-S-width model (depth 2, random weights) on the card, its
    diffusion of `steps` steps, and CFG-doubled inputs (z, o, c, y) of 120
    rows."""
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.models.dit import DiT

    torch.manual_seed(0)
    model = DiT(hidden_size=384, depth=2, num_heads=6, num_classes=7).to(device).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05)
    diffusion = create_diffusion(str(steps), noise_schedule="squaredcos_cap_v2", device=device)
    g = torch.Generator(device=device).manual_seed(1)
    z = torch.randn(1, 120, 2, generator=g, device=device).repeat(2, 1, 1)
    o = torch.cumsum(torch.rand(1, 120, generator=g, device=device) * 300, 1).repeat(2, 1)
    c = torch.rand(1, 120, 144, generator=g, device=device).repeat(2, 1, 1)
    y = torch.tensor([1, 7], device=device)
    return model, diffusion, (z, o, c, y)


@pytest.mark.cuda
def test_sampler_graph_equals_eager_chain(cuda_device):
    """A DiT-S-width model (depth 2): the graphed chain equals the eager one
    bit for bit at two lengths of one bucket, with one capture, launches
    steps x depth in each chain (the capture counts none), and no host sync
    in a replayed chain."""
    from osu_diffusion_tpu_torch.sampling import Sampler

    model, diffusion, (z, o, c, y) = _small_dit(cuda_device, 4)
    graph, eager = (Sampler(model, diffusion, cfg_scale=2.0, band=16, cuda_graph=on) for on in (True, False))
    for t in (120, 100, 120):
        args = (z[:, :t], o[:, :t], c[:, :t], y)
        before = tba.banded_attention.launches, tam.adaln_mlp.launches
        if t == 120 and graph._cache:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = graph(*args, generator=torch.Generator(device=cuda_device).manual_seed(t))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert (tba.banded_attention.launches - before[0], tam.adaln_mlp.launches - before[1]) == (8, 8)
        want = eager(*args, generator=torch.Generator(device=cuda_device).manual_seed(t))
        assert torch.equal(got, want)
    (entry,) = graph._cache.values()
    assert entry.captures == {"step": 1}


ADAPTIVE_STEPS = 8
ADAPTIVE_SPAN = (1, 2)  # of the 2 blocks: a skipped step runs block 0 only


@pytest.mark.cuda
@pytest.mark.parametrize("drift_mode", ["global", "per_sample_max"])
def test_sampler_adaptive_graph_equals_eager_chain(cuda_device, drift_mode, monkeypatch):
    """The adaptive Δ-cache graphed (a "decide" part, the record and apply
    bodies under IF nodes) against cuda_graph=False at two lengths of one
    bucket: the same bits and full steps, one capture; launches by the
    schedule (n_full x depth + skipped x (depth - span)), the first chain's
    plus the warm-up's record and apply bodies; no host sync in a replayed
    chain but its one read of n_full at the end. tau is the median of an
    eager tau-0 chain's drifts, so both bodies run."""
    from osu_diffusion_tpu_torch import sampling

    model, diffusion, (z, o, c, y) = _small_dit(cuda_device, ADAPTIVE_STEPS)
    drifts = []
    orig_drift = sampling.drift

    def recorded(*a):
        d = orig_drift(*a)
        drifts.append(d.item())
        return d

    def make(tau, cuda_graph):
        return sampling.Sampler(model, diffusion, cfg_scale=2.0, band=16, accel_tau=tau,
                                accel_span=ADAPTIVE_SPAN, accel_max_skip=2, accel_drift=drift_mode,
                                cuda_graph=cuda_graph)

    monkeypatch.setattr(sampling, "drift", recorded)
    make(0.0, False)(z, o, c, y, generator=torch.Generator(device=cuda_device).manual_seed(2))
    monkeypatch.setattr(sampling, "drift", orig_drift)
    tau = sorted(drifts[1:-1])[len(drifts[1:-1]) // 2]
    graph, eager = make(tau, True), make(tau, False)

    orig_full_steps = sampling.Chain.full_steps

    def read_n_full(self, steps):  # the chain's one read of the card, at its end
        torch.cuda.set_sync_debug_mode(0)
        try:
            return orig_full_steps(self, steps)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    depth, span = len(model.blocks), ADAPTIVE_SPAN[1] - ADAPTIVE_SPAN[0]
    for n, t in enumerate((120, 100, 120)):
        args = (z[:, :t], o[:, :t], c[:, :t], y)
        before = tba.banded_attention.launches, tam.adaln_mlp.launches
        if n:
            monkeypatch.setattr(sampling.Chain, "full_steps", read_n_full)
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = graph(*args, generator=torch.Generator(device=cuda_device).manual_seed(t))
        finally:
            torch.cuda.set_sync_debug_mode(0)
            monkeypatch.setattr(sampling.Chain, "full_steps", orig_full_steps)
        full = graph.last_full_model_steps
        launches = (tba.banded_attention.launches - before[0], tam.adaln_mlp.launches - before[1])
        want_launches = full * depth + (ADAPTIVE_STEPS - full) * (depth - span)
        if n == 0:
            want_launches += depth + depth - span  # the warm-up ran each body once
        assert launches == (want_launches, want_launches)
        want = eager(*args, generator=torch.Generator(device=cuda_device).manual_seed(t))
        assert torch.equal(got, want)
        assert type(full) is int and full == eager.last_full_model_steps and 1 < full < ADAPTIVE_STEPS
    (entry,) = graph._cache.values()
    assert entry.captures == {"adaptive": 1}


@pytest.mark.cuda
def test_calc_bpd_loop_graph_equals_eager(cuda_device):
    """calc_bpd_loop through the DiT-S-width model on the card, captured and
    replayed against cuda_graph=False: the five entries bit for bit, and
    steps x depth launches of rows 1 and 7 in each run."""
    model, diffusion, (z, o, c, y) = _small_dit(cuda_device, 6)
    x0 = z.clamp(-1, 1)

    def model_fn(x, t):
        return model(x, t, o, c, y, band=16)

    out = {}
    for cuda_graph in (True, False):
        before = tba.banded_attention.launches, tam.adaln_mlp.launches
        out[cuda_graph] = diffusion.calc_bpd_loop(model_fn, x0, generator=torch.Generator(device=cuda_device).manual_seed(3),
                                                  cuda_graph=cuda_graph)
        launches = (tba.banded_attention.launches - before[0], tam.adaln_mlp.launches - before[1])
        assert launches == (6 * len(model.blocks),) * 2
    assert all(torch.equal(out[True][k], out[False][k]) for k in out[False])
    assert all(bool(torch.isfinite(v).all()) for v in out[True].values())


def _train_state(model, ema, optimizer) -> list[torch.Tensor]:
    """Every tensor a train step moves: the weights, the EMA, AdamW's
    moments and step counts, in a fixed order."""
    moments = [t for p in model.parameters() for t in optimizer.state[p].values()]
    return [*model.parameters(), *ema.parameters(), *moments]


def _small_train(device, mlp_bwd, k, n=4, t=128):
    """A DiT-S-width model in training (depth 2, 7 classes, random weights)
    on the card, its EMA, AdamW (`make_optimizer`), the L1 process, a
    generator, and batches(seed): k stacked batches of n windows of t rows."""
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.models.dit import DiT
    from osu_diffusion_tpu_torch.train.train_step import make_ema, make_optimizer

    torch.manual_seed(0)
    model = DiT(hidden_size=384, depth=2, num_heads=6, num_classes=7, class_dropout_prob=0.2,
                mlp_bwd=mlp_bwd).to(device).train()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05)
    diffusion = create_diffusion("", noise_schedule="squaredcos_cap_v2", use_l1=True, device=device)

    def batches(seed):
        r = torch.Generator().manual_seed(seed)
        raw = torch.rand(k, n, t, 19, generator=r)
        raw[..., :2] *= torch.tensor([512.0, 384.0])
        raw[..., 2] = torch.cumsum(torch.rand(k, n, t, generator=r), -1) * 200
        return (raw.to(device), torch.full((k, n, 2), 256.0, device=device),
                torch.randint(0, 7, (k, n), generator=r).to(device))

    return (model, make_ema(model), make_optimizer(model.parameters()), diffusion,
            torch.Generator(device=device).manual_seed(1), batches)


@pytest.mark.cuda
@pytest.mark.parametrize("mlp_bwd,embed_only", [("xla", False), ("fused", False), ("xla", True)])
def test_train_call_graph_equals_eager_steps(cuda_device, mlp_bwd, embed_only):
    """A DiT-S-width model (depth 2, batch 4 x 128, bf16 stream, remat)
    through train_step.TrainCall with k = 3 (its first call eager, then
    captured) against 3 eager train_steps from the same state (weights,
    EMA, moments, step counts and generator, put back into the same
    tensors): the replayed call gives the same metrics and moves every
    tensor to the same bits, the generator's offset to the same place, adds
    3 steps' launches of rows 2, 3, 4 and 8 (9a/9b with the fused MLP
    backward) and makes no host sync; with the embed-only mask only the
    label table moves."""
    from osu_diffusion_tpu_torch.train.train_step import TrainCall, train_steps
    from osu_diffusion_tpu_torch.train.trainer import embed_only_mask

    k, t = 3, 128
    model, ema, opt, diffusion, g, batches = _small_train(cuda_device, mlp_bwd, k)
    assert all(group["capturable"] for group in opt.param_groups)
    kwargs = dict(band=t, dtype=torch.bfloat16,
                  trainable_mask=embed_only_mask(model) if embed_only else None)
    call = TrainCall(model, ema, opt, diffusion, generator=g, graphed=True, **kwargs)
    call(batches(0))  # eager, then captured
    assert call.graph is not None
    state = _train_state(model, ema, opt)
    saved, offset = [s.clone() for s in state], g.get_offset()
    inputs = batches(1)
    rows = (tba.banded_attention_fwd_lse, tam.adaln_mlp_train, tba.banded_attention_bwd_dq,
            tba.banded_attention_bwd_dkv, tam.adaln_mlp_bwd_prologue, tam.adaln_mlp_bwd_epilogue)
    before = [fn.launches for fn in rows]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = call(inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    depth = len(model.blocks)
    fused = depth if mlp_bwd == "fused" else 0
    assert [fn.launches - b for fn, b in zip(rows, before)] == \
        [k * c for c in (2 * depth, 2 * depth, depth, depth, fused, fused)]
    graphed, graphed_offset = [s.clone() for s in state], g.get_offset()

    with torch.no_grad():
        for s, v in zip(state, saved):
            s.copy_(v)
    g.set_offset(offset)
    want = train_steps(model, ema, opt, diffusion, inputs, generator=g, **kwargs)
    assert graphed_offset == g.get_offset() > offset
    assert set(got) == set(want) and all(torch.equal(got[m], want[m]) for m in want)
    assert all(torch.equal(a, b) for a, b in zip(graphed, state))
    moved = [name for (name, _), a, b in zip(model.named_parameters(), graphed, saved) if not torch.equal(a, b)]
    assert moved == (["y_embedder.embedding_table.weight"] if embed_only
                     else [name for name, _ in model.named_parameters()])


@pytest.mark.cuda
def test_train_call_captures_under_the_profiler(cuda_device, tmp_path):
    """The trainer's --profile-dir traces its first calls, so a TrainCall
    may capture inside an active torch.profiler (CPU and CUDA activities):
    at DiT-S width, k = 2, the capture and a replay under the profiler, the
    trace written with the replay's kernels in it, and a replay after it
    equal to eager steps from the same state."""
    from torch.profiler import ProfilerActivity, profile

    from osu_diffusion_tpu_torch.train.train_step import TrainCall, train_steps

    model, ema, opt, diffusion, g, batches = _small_train(cuda_device, "xla", 2)
    call = TrainCall(model, ema, opt, diffusion, generator=g, graphed=True, band=128, dtype=torch.bfloat16)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call(batches(0))
        call(batches(1))
        torch.cuda.synchronize()
    assert any("banded_attn" in e.key and e.self_device_time_total > 0 for e in prof.key_averages())
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    state = _train_state(model, ema, opt)
    saved, offset = [s.clone() for s in state], g.get_offset()
    got = call(batches(2))
    graphed = [s.clone() for s in state]
    with torch.no_grad():
        for s, v in zip(state, saved):
            s.copy_(v)
    g.set_offset(offset)
    want = train_steps(model, ema, opt, diffusion, batches(2), generator=g, band=128, dtype=torch.bfloat16)
    assert all(torch.equal(got[m], want[m]) for m in want)
    assert all(torch.equal(a, b) for a, b in zip(graphed, state))


@pytest.mark.cuda
def test_capture_survives_dead_graphs_in_reference_cycles(cuda_device):
    """A dead GraphedStep held in a reference cycle (a Sampler and its
    chains hold theirs so) is freed only by the garbage collector, and a
    collection that resets its CUDA graph during another capture would
    invalidate that capture: with the collector at its most eager
    thresholds and such garbage made before each capture, every capture of
    a program that allocates Python objects succeeds and replays."""
    import gc

    from osu_diffusion_tpu_torch.graphs import GraphedStep

    x = torch.zeros(1024, device=cuda_device)

    def program():
        for row in [[i] for i in range(200)]:  # containers: each may trigger a collection
            x.add_(row[0])

    def dead_cycle():
        holder = {"graph": GraphedStep(cuda_device, program)}
        holder["self"] = holder

    thresholds = gc.get_threshold()
    gc.collect()
    gc.set_threshold(1, 1, 1)
    try:
        for _ in range(3):
            dead_cycle()
            GraphedStep(cuda_device, program).replay()
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    assert x[0].item() == 3 * sum(range(200))
