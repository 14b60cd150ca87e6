"""Fused adaLN-modulated MLP: kernel B (inference and training forward,
and the int8 serving forward), the training backward, and their plain
PyTorch versions.

Port of osu_diffusion_tpu/ops/pallas_mlp.py: `_adaln_mlp_kernel` without
residuals (`adaln_mlp`, inference) and with them (`adaln_mlp_train`), and
`_adaln_mlp_quant_kernel` (`adaln_mlp_quant`, int8 weights), all
csrc/adaln_mlp.cu, and the default plain backward `_bwd`
(`adaln_mlp_bwd`). It computes the MLP half of a DiT block,

    out = x + gate * fc2(gelu_tanh(fc1(LN(x) * (1 + scale) + shift)))

with a non-affine two-pass LayerNorm, and keeps the (N, T, 4D) hidden
activation on chip. x and out are float32 or bfloat16 (the training
stream); shift/scale/gate and the biases are f32. The kernel's weights come
in the packed layout of `pack_weights`, in which every tile the kernel
streams is one contiguous block. In training the forward also returns the
backward's residuals: the pre-GELU `a` (N, T, H) in x's type and the
pre-gate `mlp` (N, T, D) in f32. The int8 serving forward takes f32 x
only, int8 weight codes in the same packed layout (`pack_weights(...,
dtype=torch.int8)`) and their per-output-channel scales s1 (H,), s2 (D,).

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel or raises. Each kernel launch adds one to its wrapper's `.launches`.
`AdalnMlp` is the autograd Function of the training path: it takes fc1/fc2
weights in torch's (out, in) layout, packs them itself, and returns their
gradients in that layout.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from osu_diffusion_tpu_torch.ops import cuda_build
from osu_diffusion_tpu_torch.ops.quant import dequant_matmul

ACT_DTYPES = (torch.float32, torch.bfloat16)  # activation types the kernel takes
GELU_C0 = 0.7978845608028654  # sqrt(2 / pi)
GELU_C1 = 0.044715

KERNEL_WIDTHS = (384, 768, 1024)  # D of DiT-S/B/L; the kernel is built for these
HIDDEN_CHUNK = 128  # the kernel walks the hidden dim in chunks of this width
ROW_PAD = 8  # zero elements after each packed row: the kernel's shared-memory row padding
ROW_TILE = 32  # tokens per CTA


def pack_weights(w1: torch.Tensor, w2: torch.Tensor, dtype: torch.dtype = torch.bfloat16):
    """(w1 (D, H), w2 (H, D)) -> (w1p, w2p), the layout `adaln_mlp` takes:
    w1p (H/128, D, 128 + ROW_PAD), w1 cut into 128-column chunks, chunk-major;
    w2p (H, D + ROW_PAD). Rows are padded with zeros that are never read."""
    d, h = w1.shape
    chunks = w1.to(dtype).reshape(d, h // HIDDEN_CHUNK, HIDDEN_CHUNK).permute(1, 0, 2)
    return F.pad(chunks, (0, ROW_PAD)).contiguous(), F.pad(w2.to(dtype), (0, ROW_PAD)).contiguous()


def unpack_weights(w1p: torch.Tensor, w2p: torch.Tensor):
    """Inverse of `pack_weights`: (w1 (D, H), w2 (H, D))."""
    chunks, d, _ = w1p.shape
    w1 = w1p[..., :HIDDEN_CHUNK].permute(1, 0, 2).reshape(d, chunks * HIDDEN_CHUNK)
    return w1, w2p[:, :d]


def _rounder(matmul_dtype):
    def rnd(a):
        return a.to(torch.float32).to(matmul_dtype).to(torch.float32)
    return rnd


def _layer_norm_f32(x, eps: float):
    """(xn, 1/std) of the non-affine two-pass LayerNorm, in f32."""
    xf = x.to(torch.float32)
    xc = xf - xf.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return xc * inv, inv


def adaln_mlp_train_reference(
    x, shift, scale, gate, w1, b1, w2, b2, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the training forward: (out in x's type, a (N, T, H)
    in x's type, mlp (N, T, D) f32). x: (N, T, D); shift/scale/gate: (N, D);
    w1: (D, H); w2: (H, D). Matmul operands are rounded to `matmul_dtype`
    and multiplied in f32 (bf16 = the kernel's precision contract; f32 = the
    f32 MLP); GELU takes the unrounded f32 pre-activation."""
    f32 = torch.float32
    rnd = _rounder(matmul_dtype)
    xn, _ = _layer_norm_f32(x, eps)
    h = xn * (1.0 + scale.to(f32)[:, None, :]) + shift.to(f32)[:, None, :]
    pre = torch.matmul(rnd(h), rnd(w1)) + b1.to(f32)
    mlp = torch.matmul(rnd(F.gelu(pre, approximate="tanh")), rnd(w2)) + b2.to(f32)
    out = x.to(f32) + gate.to(f32)[:, None, :] * mlp
    return out.to(x.dtype), pre.to(x.dtype), mlp


def adaln_mlp_reference(
    x, shift, scale, gate, w1, b1, w2, b2, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of the inference forward (the training forward's
    output alone)."""
    return adaln_mlp_train_reference(x, shift, scale, gate, w1, b1, w2, b2, eps, matmul_dtype)[0]


def adaln_mlp_quant_reference(
    x, shift, scale, gate, w1q, s1, b1, w2q, s2, b2, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain version of the int8 serving forward. w1q: (D, H), w2q: (H, D)
    int8 codes; s1: (H,), s2: (D,) their per-output-channel f32 scales.
    bfloat16: the kernel's rounding (bf16 activations times the exact codes,
    each scale applied to its f32 product); float32: the f32 MLP over the
    dequantised weights (`ops/quant.py`, dequant_matmul)."""
    f32 = torch.float32
    xn, _ = _layer_norm_f32(x, eps)
    h = xn * (1.0 + scale.to(f32)[:, None, :]) + shift.to(f32)[:, None, :]
    pre = dequant_matmul(h, w1q.t(), s1, matmul_dtype) + b1
    mlp = dequant_matmul(F.gelu(pre, approximate="tanh"), w2q.t(), s2, matmul_dtype) + b2
    return x + gate.to(f32)[:, None, :] * mlp


def _mm(a: torch.Tensor, b: torch.Tensor, matmul_dtype) -> torch.Tensor:
    """a @ b with operands rounded to `matmul_dtype` and an f32 result.

    `torch.matmul` of two bf16 tensors would round its result to bf16, not
    keep it in f32 as the JAX backward's preferred_element_type=f32 does.
    On a CUDA device bf16 operands therefore go to cuBLAS through
    `torch.mm(..., out_dtype=torch.float32)` (bf16 tensor-core products, f32
    accumulation and result); elsewhere the rounded operands are multiplied
    in f32, which computes the same function."""
    if a.is_cuda and matmul_dtype == torch.bfloat16:
        return torch.mm(a.to(matmul_dtype), b.to(matmul_dtype), out_dtype=torch.float32)
    rnd = _rounder(matmul_dtype)
    return torch.mm(rnd(a), rnd(b))


def adaln_mlp_bwd(
    x, shift, scale, gate, fc1_w, fc2_w, a, mlp, g, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.float32,
):
    """The FLOP-minimal backward (JAX `_bwd`): from the residuals a and mlp,
    only the four unavoidable matmuls; LayerNorm, modulation and GELU are
    recomputed elementwise. fc1_w (H, D) and fc2_w (D, H) are torch's
    Linear weights. Returns (dx in x's type, dshift, dscale, dgate, dfc1_w,
    db1, dfc2_w, db2), the weight gradients in torch's (out, in) layout."""
    f32 = torch.float32
    n, t, d = x.shape
    hdim = fc1_w.shape[0]
    g = g.to(f32)
    xn, inv = _layer_norm_f32(x, eps)
    scale1 = 1.0 + scale.to(f32)[:, None, :]
    h1 = xn * scale1 + shift.to(f32)[:, None, :]
    af = a.to(f32)
    th = torch.tanh(GELU_C0 * (af + GELU_C1 * af * af * af))
    gelu_out = 0.5 * af * (1.0 + th)
    dgelu_da = 0.5 * (1.0 + th) + 0.5 * af * (1.0 - th * th) * GELU_C0 * (1.0 + 3.0 * GELU_C1 * af * af)

    # out = x + gate * mlp
    dgate = (g * mlp.to(f32)).sum(dim=1)
    dmlp = (g * gate.to(f32)[:, None, :]).reshape(n * t, d)
    # mlp = gelu(a) @ w2 + b2
    db2 = dmlp.sum(dim=0)
    dfc2_w = _mm(dmlp.t(), gelu_out.reshape(n * t, hdim), matmul_dtype)
    da = _mm(dmlp, fc2_w, matmul_dtype) * dgelu_da.reshape(n * t, hdim)
    # a = h1 @ w1 + b1
    db1 = da.sum(dim=0)
    dfc1_w = _mm(da.t(), h1.reshape(n * t, d), matmul_dtype)
    dh1 = _mm(da, fc1_w, matmul_dtype).reshape(n, t, d)
    # h1 = xn * (1 + scale) + shift, then the non-affine LayerNorm
    dshift = dh1.sum(dim=1)
    dscale = (dh1 * xn).sum(dim=1)
    dxn = dh1 * scale1
    dx_ln = inv * (dxn - dxn.mean(dim=-1, keepdim=True) - xn * (dxn * xn).mean(dim=-1, keepdim=True))
    return ((g + dx_ln).to(x.dtype), dshift, dscale, dgate, dfc1_w.to(fc1_w.dtype), db1,
            dfc2_w.to(fc2_w.dtype), db2)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("adaln_mlp")
    fn = lib.adaln_mlp_fwd
    fn.restype = ctypes.c_int
    # (x, shift, scale, gate, mod_stride, w1p, b1, w2p, b2, ws, out, a, mlp,
    #  n, t, d, hdim, split, eps, bf16, stream)
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn = lib.adaln_mlp_quant_fwd
    fn.restype = ctypes.c_int
    # (x, shift, scale, gate, mod_stride, w1p, s1, b1, w2p, s2, b2, ws, out,
    #  n, t, d, hdim, split, eps, stream)
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.adaln_mlp_error_string.restype = ctypes.c_char_p
    lib.adaln_mlp_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def hidden_split(n: int, t: int, hdim: int, sm_count: int) -> int:
    """How many CTAs share one token tile's hidden dim: the largest divisor
    of the chunk count that keeps the grid within one wave of CTAs (one per
    SM), so short sequences still fill the card. Each split adds an
    (N, T, D) f32 partial that the epilogue kernel sums."""
    chunks = hdim // HIDDEN_CHUNK
    tiles = n * -(-t // ROW_TILE)
    return max(s for s in range(1, chunks + 1) if chunks % s == 0 and (s == 1 or tiles * s <= sm_count))


def _check_kernel_inputs(x, shift, scale, gate, w1p, b1, w2p, b2, matmul_dtype,
                         w_dtype=torch.bfloat16, **scales) -> None:
    """`w_dtype`: the packed weights' type, bf16 or int8 (then `scales`
    holds s1 and s2)."""
    if matmul_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel computes with bf16 operands; "
                         f"matmul_dtype={matmul_dtype} has no kernel")
    n, t, d = x.shape
    hdim = w2p.shape[0]
    if d not in KERNEL_WIDTHS:
        raise ValueError(f"the kernel takes D in {KERNEL_WIDTHS}, got {d}")
    if hdim % HIDDEN_CHUNK:
        raise ValueError(f"hidden width {hdim} is not a multiple of {HIDDEN_CHUNK}")
    if x.dtype not in ACT_DTYPES:
        raise TypeError(f"x must be one of {ACT_DTYPES}, got {x.dtype}")
    expect = {
        "x": (x, x.dtype, (n, t, d)),
        "shift": (shift, torch.float32, (n, d)),
        "scale": (scale, torch.float32, (n, d)),
        "gate": (gate, torch.float32, (n, d)),
        "w1p": (w1p, w_dtype, (hdim // HIDDEN_CHUNK, d, HIDDEN_CHUNK + ROW_PAD)),
        "b1": (b1, torch.float32, (hdim,)),
        "w2p": (w2p, w_dtype, (hdim, d + ROW_PAD)),
        "b2": (b2, torch.float32, (d,)),
        **{name: (a, torch.float32, (hdim,) if name == "s1" else (d,)) for name, a in scales.items()},
    }
    for name, (a, dtype, shape) in expect.items():
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {shape}")
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if name in ("shift", "scale", "gate"):
            if a.stride() != shift.stride() or a.stride(1) != 1 or a.stride(0) % 4:
                raise ValueError(
                    "shift/scale/gate need one shared row stride, a multiple "
                    f"of 4, and unit column stride; {name} has {a.stride()}"
                )
        elif not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if n > 65535:
        raise ValueError(f"batch {n} exceeds the kernel's grid limit 65535")


def _launch(x, shift, scale, gate, w1p, b1, w2p, b2, eps, matmul_dtype, residuals: bool):
    _check_kernel_inputs(x, shift, scale, gate, w1p, b1, w2p, b2, matmul_dtype)
    n, t, d = x.shape
    hdim = w2p.shape[0]
    split = hidden_split(n, t, hdim, _sm_count(x.device.index))
    t_pad = -(-t // ROW_TILE) * ROW_TILE
    workspace = torch.empty((split, n, t_pad, d), device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    a = torch.empty((n, t, hdim), device=x.device, dtype=x.dtype) if residuals else None
    mlp = torch.empty((n, t, d), device=x.device, dtype=torch.float32) if residuals else None
    lib = _lib()
    err = lib.adaln_mlp_fwd(
        x.data_ptr(), shift.data_ptr(), scale.data_ptr(), gate.data_ptr(),
        shift.stride(0), w1p.data_ptr(), b1.data_ptr(), w2p.data_ptr(), b2.data_ptr(),
        workspace.data_ptr(), out.data_ptr(), a.data_ptr() if residuals else None,
        mlp.data_ptr() if residuals else None, n, t, d, hdim, split, eps,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        msg = lib.adaln_mlp_error_string(err).decode()
        raise RuntimeError(f"adaln_mlp kernel launch failed: CUDA error {err} ({msg})")
    return out, a, mlp


def _check_device(x) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no adaln_mlp for device {x.device}")


def adaln_mlp(
    x, shift, scale, gate, w1p, b1, w2p, b2, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Inference forward. x: (N, T, D) f32 or bf16; shift/scale/gate: (N, D)
    f32 (row views of one modulation tensor are fine); w1p, w2p: fc1/fc2
    weights packed by `pack_weights` (bf16 on the card); b1: (H,), b2: (D,)
    f32. Returns x + gate * MLP(modulate(LN(x))) in x's type."""
    _check_device(x)
    if x.device.type == "cpu":
        w1, w2 = unpack_weights(w1p, w2p)
        return adaln_mlp_reference(x, shift, scale, gate, w1, b1, w2, b2, eps, matmul_dtype)
    out, _, _ = _launch(x, shift, scale, gate, w1p, b1, w2p, b2, eps, matmul_dtype, residuals=False)
    adaln_mlp.launches += 1
    return out


def adaln_mlp_train(
    x, shift, scale, gate, w1p, b1, w2p, b2, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training forward, the inputs of `adaln_mlp`: (out, a (N, T, H) in
    x's type, mlp (N, T, D) f32)."""
    _check_device(x)
    if x.device.type == "cpu":
        w1, w2 = unpack_weights(w1p, w2p)
        return adaln_mlp_train_reference(x, shift, scale, gate, w1, b1, w2, b2, eps, matmul_dtype)
    res = _launch(x, shift, scale, gate, w1p, b1, w2p, b2, eps, matmul_dtype, residuals=True)
    adaln_mlp_train.launches += 1
    return res


class AdalnMlp(torch.autograd.Function):
    """The MLP half of a DiT block, differentiable: the training forward
    (kernel B with residuals on the card), then `adaln_mlp_bwd`.

    fc1_w (H, D) and fc2_w (D, H) are the Linear weights themselves (not a
    cached packed copy, which holds no autograd history): the forward packs
    them and the backward returns their gradients."""

    @staticmethod
    def forward(ctx, x, shift, scale, gate, fc1_w, b1, fc2_w, b2, eps: float, matmul_dtype):
        _check_device(x)
        if x.is_cuda:
            w1p, w2p = pack_weights(fc1_w.t(), fc2_w.t(), matmul_dtype)
            out, a, mlp = adaln_mlp_train(x, shift, scale, gate, w1p, b1, w2p, b2, eps, matmul_dtype)
        else:
            out, a, mlp = adaln_mlp_train_reference(
                x, shift, scale, gate, fc1_w.t(), b1, fc2_w.t(), b2, eps, matmul_dtype)
        ctx.save_for_backward(x, shift, scale, gate, fc1_w, fc2_w, a, mlp)
        ctx.args = (eps, matmul_dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        grads = adaln_mlp_bwd(*ctx.saved_tensors, g, *ctx.args)
        return (*grads, None, None)


def adaln_mlp_quant(
    x, shift, scale, gate, w1p, s1, b1, w2p, s2, b2, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """int8 serving forward (inference only). x: (N, T, D) float32 (the
    serving stream; anything else raises TypeError); shift/scale/gate: (N, D)
    f32; w1p, w2p: int8 fc1/fc2 codes packed by `pack_weights(w1q, w2q,
    torch.int8)` from w1q (D, H), w2q (H, D); s1: (H,), s2: (D,) f32 scales;
    b1: (H,), b2: (D,) f32. Returns x + gate * MLP(modulate(LN(x))) in f32."""
    if x.dtype != torch.float32:
        raise TypeError(f"adaln_mlp_quant requires float32 activations, got {x.dtype}")
    _check_device(x)
    if x.device.type == "cpu":
        w1q, w2q = unpack_weights(w1p, w2p)
        return adaln_mlp_quant_reference(x, shift, scale, gate, w1q, s1, b1, w2q, s2, b2, eps,
                                         matmul_dtype)
    _check_kernel_inputs(x, shift, scale, gate, w1p, b1, w2p, b2, matmul_dtype, torch.int8,
                         s1=s1, s2=s2)
    n, t, d = x.shape
    hdim = w2p.shape[0]
    split = hidden_split(n, t, hdim, _sm_count(x.device.index))
    workspace = torch.empty((split, n, -(-t // ROW_TILE) * ROW_TILE, d), device=x.device,
                            dtype=torch.float32)
    out = torch.empty_like(x)
    lib = _lib()
    err = lib.adaln_mlp_quant_fwd(
        x.data_ptr(), shift.data_ptr(), scale.data_ptr(), gate.data_ptr(), shift.stride(0),
        w1p.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2p.data_ptr(), s2.data_ptr(), b2.data_ptr(),
        workspace.data_ptr(), out.data_ptr(), n, t, d, hdim, split, eps,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        msg = lib.adaln_mlp_error_string(err).decode()
        raise RuntimeError(f"adaln_mlp_quant kernel launch failed: CUDA error {err} ({msg})")
    adaln_mlp_quant.launches += 1
    return out


adaln_mlp.launches = 0
adaln_mlp_train.launches = 0
adaln_mlp_quant.launches = 0
