"""The port's fused adaLN-MLP backward against the JAX package's, on the
CPU: the two stages' plain versions against the outputs of the two Pallas
kernels of `pallas_mlp._bwd_fused_impl` (interpret mode, as the JAX
package's own tests run them), recorded from their `pallas_call`s; and the
`AdalnMlp` Function with `bwd_impl="fused"` against `jax.vjp` of
`pallas_mlp.adaln_mlp(..., "fused")`. Inputs are made with numpy from a seed.

Tolerances, as max |port - jax| / max |jax| per output (the reasons are in
tests/test_torch_train_ops.py): 1e-4 at f32 operands and stream (f32 sums
in another order; the stages' reductions run over up to N*T = 60 terms),
2e-2 at the bf16 stream and operands.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import osu_diffusion_tpu.ops.pallas_mlp as pm
from osu_diffusion_tpu_torch.ops import adaln_mlp as tam

TOL = {"f32": 1e-4, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def recorded_calls(monkeypatch):
    """Pallas in interpret mode; every pallas_call's (inputs, outputs) is
    appended to the returned list."""
    calls = []
    orig = pm.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        fn = orig(*args, **kwargs)

        def run(*inputs):
            outs = fn(*inputs)
            calls.append(([np.asarray(jnp.asarray(a, jnp.float32)) for a in inputs],
                          [np.asarray(jnp.asarray(o, jnp.float32)) for o in outs]))
            return outs
        return run

    monkeypatch.setattr(pm.pl, "pallas_call", patched)
    return calls


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.detach().double().numpy() - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(n, t, d, hdim, seed):
    r = np.random.RandomState(seed)
    x = r.randn(n, t, d).astype(np.float32)
    shift, scale, gate = ((0.3 * r.randn(n, d)).astype(np.float32) for _ in range(3))
    w1 = (r.randn(d, hdim) / np.sqrt(d)).astype(np.float32)
    w2 = (r.randn(hdim, d) / np.sqrt(hdim)).astype(np.float32)
    b1, b2 = (0.1 * r.randn(hdim)).astype(np.float32), (0.1 * r.randn(d)).astype(np.float32)
    g = r.randn(n, t, d).astype(np.float32)
    return (x, shift, scale, gate, w1, b1, w2, b2), g


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("t,block_t,block_h", [(20, 8, 16), (16, 16, None)],
                         ids=["ragged_t-block_h16", "one_block"])
def test_stages_match_the_pallas_kernels(recorded_calls, stream, t, block_t, block_h):
    """Each of the ten stage outputs against the JAX kernel's, on the inputs
    the JAX kernels were given (g cast to the stream, T padded to the block,
    the padded rows zero): block_h=16 makes the JAX side cross several hidden
    blocks (its db1 rows and dh1 scratch accumulation), T=20 a ragged tail."""
    jdt, tdt = DTYPES[stream]
    args, g = _inputs(3, t, 32, 64, seed=t)
    jargs = (jnp.asarray(args[0], jdt),) + tuple(jnp.asarray(a) for a in args[1:])
    _, res = pm._fwd(*jargs, block_t, 1e-6, jdt, "fused")
    recorded_calls.clear()  # the forward's call
    pm._bwd_fused_impl(res, jnp.asarray(g, jdt), block_t, 1e-6, jdt, block_h=block_h)
    assert len(recorded_calls) == 2
    (p_in, p_out), (e_in, e_out) = recorded_calls
    tol = TOL[stream]

    def tt(a, dtype=torch.float32):
        return torch.from_numpy(a.copy()).to(dtype)

    g_, mlp, a, gate, w2 = p_in
    got = tam.adaln_mlp_bwd_prologue_reference(tt(g_, tdt), tt(mlp), tt(a, tdt), tt(gate), tt(w2), tdt)
    names = ("da", "gelu_out", "dmlp", "dgate", "db1", "db2")
    got_da = got[0]
    for name, gg, w in zip(names, got, p_out):
        assert gg.dtype == (tdt if name in names[:3] else torch.float32), name
        assert rel_err(gg, w.reshape(gg.shape)) <= tol, (name, rel_err(gg, w.reshape(gg.shape)))

    da, x, g_, shift, scale, w1 = e_in
    got = tam.adaln_mlp_bwd_epilogue_reference(tt(da, tdt), tt(x, tdt), tt(g_, tdt), tt(shift), tt(scale),
                                               tt(w1), 1e-6, tdt)
    for name, gg, w in zip(("dx", "h1", "dshift", "dscale"), got, e_out):
        assert tuple(gg.shape) == w.shape, name
        assert rel_err(gg, w) <= tol, (name, rel_err(gg, w))
    # the zero rows of g past T give zero da on both sides
    assert np.all(p_out[0][:, t:] == 0) and (got_da[:, t:] == 0).all()


def test_stage_wrappers_take_the_plain_versions_on_cpu():
    """On CPU tensors the wrappers take the weights in torch's Linear layout
    (fc2 (D, H), fc1 (H, D)) and return the plain versions' outputs exactly,
    launching nothing."""
    args, g = _inputs(2, 10, 32, 128, seed=1)
    x, shift, scale, gate, w1, b1, w2, b2 = (torch.from_numpy(a) for a in args)
    g = torch.from_numpy(g)
    _, a, mlp = tam.adaln_mlp_train_reference(x, shift, scale, gate, w1, b1, w2, b2)
    fc1_w, fc2_w = w1.t().contiguous(), w2.t().contiguous()
    counts = (tam.adaln_mlp_bwd_prologue.launches, tam.adaln_mlp_bwd_epilogue.launches)
    got = tam.adaln_mlp_bwd_prologue(g, mlp, a, gate, fc2_w)
    want = tam.adaln_mlp_bwd_prologue_reference(g, mlp, a, gate, w2, torch.bfloat16)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    got = tam.adaln_mlp_bwd_epilogue(want[0], x, g, shift, scale, fc1_w)
    want = tam.adaln_mlp_bwd_epilogue_reference(want[0], x, g, shift, scale, w1, 1e-6, torch.bfloat16)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert counts == (tam.adaln_mlp_bwd_prologue.launches, tam.adaln_mlp_bwd_epilogue.launches)


@pytest.mark.parametrize("act,md", [("f32", "f32"), ("f32", "bf16"), ("bf16", "bf16")])
def test_fused_function_matches_jax_vjp(recorded_calls, act, md):
    """All eight gradients of AdalnMlp(bwd_impl="fused") against jax.vjp of
    pallas_mlp.adaln_mlp(..., "fused"), at the cases of
    test_adaln_mlp_vjp_matches_jax (tolerances as there: 1e-5 at f32, 1e-2
    at bf16 operands, 2e-2 at the bf16 stream)."""
    tol = {("f32", "f32"): 1e-5, ("f32", "bf16"): 1e-2, ("bf16", "bf16"): 2e-2}[(act, md)]
    jdt, tdt = DTYPES[act]
    jmd, tmd = DTYPES[md]
    args, g = _inputs(2, 40, 128, 512, seed=3)

    def jax_mlp(*a):
        return pm.adaln_mlp(*a, 16, 1e-6, jmd, "fused")

    jargs = (jnp.asarray(args[0], jdt),) + tuple(jnp.asarray(a) for a in args[1:])
    want_out, vjp = jax.vjp(jax_mlp, *jargs)
    want = vjp(jnp.asarray(g, jdt))
    assert len(recorded_calls) == 3  # the forward and both backward kernels

    x, shift, scale, gate, w1, b1, w2, b2 = args
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tshift, tscale, tgate, tb1, tb2 = (torch.from_numpy(a).requires_grad_() for a in (shift, scale, gate, b1, b2))
    fc1_w = torch.from_numpy(w1.T.copy()).requires_grad_()
    fc2_w = torch.from_numpy(w2.T.copy()).requires_grad_()
    out = tam.AdalnMlp.apply(tx, tshift, tscale, tgate, fc1_w, tb1, fc2_w, tb2, 1e-6, tmd, "fused")
    out.backward(torch.from_numpy(g).to(tdt))
    assert out.dtype == tdt and tx.grad.dtype == tdt
    assert rel_err(out, np.asarray(jnp.asarray(want_out, jnp.float32))) <= tol
    got = (tx.grad, tshift.grad, tscale.grad, tgate.grad, fc1_w.grad.t(), tb1.grad, fc2_w.grad.t(), tb2.grad)
    for name, gg, w in zip(("x", "shift", "scale", "gate", "w1", "b1", "w2", "b2"), got, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        assert tuple(gg.shape) == w.shape, name
        assert rel_err(gg, w) <= tol, (name, rel_err(gg, w))


def test_unknown_bwd_impl_raises():
    x = torch.zeros(1, 4, 32)
    m = torch.zeros(1, 32)
    with pytest.raises(ValueError, match="bwd_impl"):
        tam.AdalnMlp.apply(x, m, m, m, torch.zeros(128, 32), torch.zeros(128), torch.zeros(32, 128),
                           torch.zeros(32), 1e-6, torch.float32, "pallas")
