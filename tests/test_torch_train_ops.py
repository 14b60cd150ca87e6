"""The port's training ops against the JAX package's Pallas kernels, on the
CPU: the banded-attention and adaLN-MLP autograd Functions against
`jax.vjp` of `banded_flash_attention` and `pallas_mlp.adaln_mlp` (Pallas in
interpret mode, as the JAX package's own tests run it), with their LSE and
residual outputs. On the CPU the Functions run the kernels' plain versions,
so this holds the custom backward's math, not torch autograd of a dense
softmax. Inputs are made with numpy from a seed.

Tolerances, as max |port - jax| / max |jax| per output:
- matmul_dtype f32: both sides are f32 products over the same operands,
  differing only in summation order: 1e-5.
- matmul_dtype bf16: both sides round the same f32 values to bf16 before
  each product, but an ulp-level difference in an f32 intermediate (a
  score, P, dS, the hidden activation) can flip one bf16 rounding (2^-8
  relative) of an operand; 1e-2 covers a few such flips in a sum and is far
  below what a wrong index or mask gives (O(1)). With bf16 activations the
  outputs are bf16 themselves (2^-8), hence 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osu_diffusion_tpu.ops.pallas_attention as pa
import osu_diffusion_tpu.ops.pallas_mlp as pm
from osu_diffusion_tpu_torch.ops import adaln_mlp as tam
from osu_diffusion_tpu_torch.ops import banded_attention as tba

TOL = {("f32", "f32"): 1e-5, ("f32", "bf16"): 1e-2, ("bf16", "bf16"): 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def interpret_mode(monkeypatch):
    """Pallas kernels in interpret mode on the CPU."""
    for mod in (pa, pm):
        orig = mod.pl.pallas_call

        def patched(*args, _orig=orig, **kwargs):
            kwargs.setdefault("interpret", True)
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod.pl, "pallas_call", patched)


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return float(np.abs(got.detach().double().numpy() - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("t,valid,band,act,md", [
    (64, 64, 64, "f32", "f32"), (64, 64, 64, "bf16", "bf16"),
    (48, 40, 16, "f32", "bf16"), (40, 33, 8, "f32", "f32"),
], ids=["t_eq_band-f32", "t_eq_band-bf16_stream", "valid_lt_t_band_lt_t-bf16", "ragged-f32"])
def test_banded_attention_vjp_matches_jax(interpret_mode, t, valid, band, act, md):
    """dq, dk, dv and the LSE of the port's BandedAttention against jax.vjp,
    at matmul_dtype f32 and bf16, T = band, valid_len < T and band < T. The
    LSE is held against both JAX layouts (lane-broadcast and, at f32,
    sublane-packed)."""
    jdt, tdt = DTYPES[act]
    jmd, tmd = DTYPES[md]
    n, h, dh, block = 2, 2, 64, 16
    r = np.random.RandomState(t + band)
    q, k, v, do = (r.randn(n, h, t, dh).astype(np.float32) for _ in range(4))

    def jax_attn(q_, k_, v_):
        return pa.banded_flash_attention(q_, k_, v_, band, block=block, matmul_dtype=jmd,
                                         t_real=valid, slim_stats=False)

    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    want_o, vjp = jax.vjp(jax_attn, jq, jk, jv)
    want = vjp(jdo)

    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    got_o = tba.banded_attention(tq, tk, tv, band, valid, tmd)
    got_o.backward(torch.from_numpy(do).to(tdt))
    tol = TOL[(act, md)]
    assert got_o.dtype == tdt and tq.grad.dtype == tdt
    assert rel_err(got_o, want_o) <= tol
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        assert rel_err(g, w) <= tol, name
    # queries past valid_len get no gradient
    assert (tq.grad[:, :, valid:] == 0).all()

    _, lse = tba.banded_attention_fwd_lse(tq.detach(), tk.detach(), tv.detach(), band, valid, tmd)
    assert lse.shape == (n * h, t) and lse.dtype == torch.float32
    for slim in (False, True) if md == "f32" else (False,):
        _, jl = pa._banded_flash_fwd_impl(jq, jk, jv, band, block, jmd, valid,
                                          with_lse=True, slim_stats=slim)
        jl = np.asarray(jl)[:, 0, :t] if slim else np.asarray(jl)[:, :t]
        np.testing.assert_allclose(lse.numpy(), jl, rtol=0, atol=1e-4)


def test_banded_attention_without_grad_keeps_the_inference_path():
    """Under no_grad, or with no input requiring grad, the wrapper is the
    inference forward: the same output, no autograd history."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 40, 64, generator=g) for _ in range(3))
    want = tba.banded_attention_reference(q, k, v, 8, 33, torch.bfloat16)
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        out = tba.banded_attention(qg, k, v, 8, 33)
    assert out.grad_fn is None and torch.equal(out, want)
    out = tba.banded_attention(qg, k, v, 8, 33)
    assert out.grad_fn is not None and torch.equal(out.detach(), want)


@pytest.mark.parametrize("act,md", [("f32", "f32"), ("f32", "bf16"), ("bf16", "bf16")])
def test_adaln_mlp_vjp_matches_jax(interpret_mode, act, md):
    """All eight gradients, and the a / mlp residuals, of the port's
    AdalnMlp against jax.vjp of pallas_mlp.adaln_mlp (the plain "xla"
    backward, the JAX default)."""
    jdt, tdt = DTYPES[act]
    jmd, tmd = DTYPES[md]
    n, t, d, hdim = 2, 40, 128, 512
    r = np.random.RandomState(3)
    x = r.randn(n, t, d).astype(np.float32)
    shift, scale, gate = (0.3 * r.randn(n, d)).astype(np.float32), (0.3 * r.randn(n, d)).astype(np.float32), \
        (0.3 * r.randn(n, d)).astype(np.float32)
    w1 = (r.randn(d, hdim) / np.sqrt(d)).astype(np.float32)
    w2 = (r.randn(hdim, d) / np.sqrt(hdim)).astype(np.float32)
    b1, b2 = (0.1 * r.randn(hdim)).astype(np.float32), (0.1 * r.randn(d)).astype(np.float32)
    g = r.randn(n, t, d).astype(np.float32)
    args = (x, shift, scale, gate, w1, b1, w2, b2)

    def jax_mlp(*a):
        return pm.adaln_mlp(*a, 16, 1e-6, jmd, "xla")

    jargs = (jnp.asarray(x, jdt),) + tuple(jnp.asarray(a) for a in args[1:])
    want_out, vjp = jax.vjp(jax_mlp, *jargs)
    want = vjp(jnp.asarray(g, jdt))
    _, want_a, want_mlp = pm._adaln_mlp_fwd_impl(*jargs, 16, 1e-6, jmd, with_residuals=True)

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tshift, tscale, tgate, tb1, tb2 = (torch.from_numpy(a).requires_grad_() for a in (shift, scale, gate, b1, b2))
    fc1_w = torch.from_numpy(w1.T.copy()).requires_grad_()  # torch Linear layout (out, in)
    fc2_w = torch.from_numpy(w2.T.copy()).requires_grad_()
    out = tam.AdalnMlp.apply(tx, tshift, tscale, tgate, fc1_w, tb1, fc2_w, tb2, 1e-6, tmd)
    out.backward(torch.from_numpy(g).to(tdt))
    tol = TOL[(act, md)]
    assert out.dtype == tdt and tx.grad.dtype == tdt
    assert rel_err(out, want_out) <= tol
    got = (tx.grad, tshift.grad, tscale.grad, tgate.grad, fc1_w.grad.t(), tb1.grad, fc2_w.grad.t(), tb2.grad)
    for name, gg, w in zip(("x", "shift", "scale", "gate", "w1", "b1", "w2", "b2"), got, want):
        assert tuple(gg.shape) == tuple(w.shape), name
        assert rel_err(gg, w) <= tol, name

    # the residuals, through the training wrapper's plain version
    w1t, w2t = (torch.from_numpy(w).t().to(tmd).contiguous() for w in (w1, w2))
    _, a, mlp = tam.adaln_mlp_train(tx.detach(), *(torch.from_numpy(v) for v in (shift, scale, gate)),
                                    w1t, torch.from_numpy(b1), w2t, torch.from_numpy(b2), 1e-6, tmd)
    assert a.dtype == tdt and mlp.dtype == torch.float32
    assert rel_err(a, want_a) <= tol and rel_err(mlp, want_mlp) <= tol
