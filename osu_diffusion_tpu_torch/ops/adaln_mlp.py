"""Fused adaLN-modulated MLP: kernel B (inference and training forward,
and the int8 serving forward), the training backward, and their plain
PyTorch versions.

Port of osu_diffusion_tpu/ops/pallas_mlp.py: `_adaln_mlp_kernel` without
residuals (`adaln_mlp`, inference) and with them (`adaln_mlp_train`), and
`_adaln_mlp_quant_kernel` (`adaln_mlp_quant`, int8 weights), all
csrc/adaln_mlp.cu; the default plain backward `_bwd` (`adaln_mlp_bwd`);
and the fused backward `_bwd_fused_impl` (`adaln_mlp_bwd_fused`), whose
two stages `_bwd_prologue_kernel` and `_bwd_epilogue_kernel` are
`adaln_mlp_bwd_prologue` and `adaln_mlp_bwd_epilogue`,
csrc/adaln_mlp_bwd.cu. It computes the MLP half of a DiT block,

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
gradients in that layout; `bwd_impl` picks the plain or the fused backward.
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


def _gelu_and_grad(af: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """GELU-tanh of the f32 pre-activation and its derivative."""
    th = torch.tanh(GELU_C0 * (af + GELU_C1 * af * af * af))
    dgelu_da = 0.5 * (1.0 + th) + 0.5 * af * (1.0 - th * th) * GELU_C0 * (1.0 + 3.0 * GELU_C1 * af * af)
    return 0.5 * af * (1.0 + th), dgelu_da


def _layer_norm_bwd(dxn, xn, inv):
    """The non-affine LayerNorm's input gradient from dL/dxn."""
    return inv * (dxn - dxn.mean(dim=-1, keepdim=True) - xn * (dxn * xn).mean(dim=-1, keepdim=True))


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
    gelu_out, dgelu_da = _gelu_and_grad(a.to(f32))

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
    dx = g + _layer_norm_bwd(dh1 * scale1, xn, inv)
    return (dx.to(x.dtype), dshift, dscale, dgate, dfc1_w.to(fc1_w.dtype), db1,
            dfc2_w.to(fc2_w.dtype), db2)


def adaln_mlp_bwd_prologue_reference(g, mlp, a, gate, w2, matmul_dtype: torch.dtype = torch.float32):
    """Plain version of the fused backward's first stage (JAX
    `_bwd_prologue_kernel`). g: (N, T, D) upstream gradient in the stream's
    type; mlp: (N, T, D) f32 and a: (N, T, H) the forward's residuals; gate:
    (N, D); w2: (H, D). Returns (da, gelu(a) (N, T, H), dmlp (N, T, D) in g's
    type; dgate (N, D), db1 (H,), db2 (D,) f32). dgelu = dmlp @ w2^T takes
    operands rounded to `matmul_dtype` and sums in f32; GELU' comes from the
    f32 `a`; db1 sums the unrounded da."""
    f32 = torch.float32
    n, t, d = g.shape
    gf = g.to(f32)
    dmlp = gf * gate.to(f32)[:, None, :]
    dgate = (gf * mlp.to(f32)).sum(dim=1)
    dgelu = _mm(dmlp.reshape(n * t, d), w2.t(), matmul_dtype).reshape(n, t, -1)
    gelu_out, dgelu_da = _gelu_and_grad(a.to(f32))
    da = dgelu * dgelu_da
    return (da.to(g.dtype), gelu_out.to(g.dtype), dmlp.to(g.dtype), dgate, da.sum(dim=(0, 1)),
            dmlp.sum(dim=(0, 1)))


def adaln_mlp_bwd_epilogue_reference(da, x, g, shift, scale, w1, eps: float = 1e-6,
                                     matmul_dtype: torch.dtype = torch.float32):
    """Plain version of the fused backward's second stage (JAX
    `_bwd_epilogue_kernel`). da: (N, T, H) and x, g: (N, T, D) in the
    stream's type; shift/scale: (N, D); w1: (D, H). Returns (dx, h1 (N, T, D)
    in x's type; dshift, dscale (N, D) f32): dh1 = da @ w1^T (operands
    rounded to `matmul_dtype`, f32 sums), then the modulation and LayerNorm
    backward."""
    f32 = torch.float32
    n, t, d = x.shape
    xn, inv = _layer_norm_f32(x, eps)
    scale1 = 1.0 + scale.to(f32)[:, None, :]
    h1 = xn * scale1 + shift.to(f32)[:, None, :]
    dh1 = _mm(da.reshape(n * t, -1), w1.t(), matmul_dtype).reshape(n, t, d)
    dx = g.to(f32) + _layer_norm_bwd(dh1 * scale1, xn, inv)
    return dx.to(x.dtype), h1.to(x.dtype), dh1.sum(dim=1), (dh1 * xn).sum(dim=1)


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
def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load_library("adaln_mlp_bwd")
    fn = lib.adaln_mlp_bwd_prologue
    fn.restype = ctypes.c_int
    # (g, mlp, a, gate, mod_stride, w2p, da, gelu_out, dmlp, dgate, db1, db2,
    #  ws, n, t, d, hdim, split, bf16, stream)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn = lib.adaln_mlp_bwd_epilogue
    fn.restype = ctypes.c_int
    # (da, x, g, shift, scale, mod_stride, w1p, dx, h1, dshift, dscale, ws,
    #  n, t, d, hdim, eps, bf16, stream)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.adaln_mlp_bwd_error_string.restype = ctypes.c_char_p
    lib.adaln_mlp_bwd_error_string.argtypes = [ctypes.c_int]
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


def _check_widths(x, hdim: int, matmul_dtype) -> None:
    """What every adaLN-MLP kernel takes: bf16 operands, D in
    KERNEL_WIDTHS, H a multiple of 128, an f32 or bf16 stream, N <= 65535."""
    if matmul_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel computes with bf16 operands; "
                         f"matmul_dtype={matmul_dtype} has no kernel")
    n, _, d = x.shape
    if d not in KERNEL_WIDTHS:
        raise ValueError(f"the kernel takes D in {KERNEL_WIDTHS}, got {d}")
    if hdim % HIDDEN_CHUNK:
        raise ValueError(f"hidden width {hdim} is not a multiple of {HIDDEN_CHUNK}")
    if x.dtype not in ACT_DTYPES:
        raise TypeError(f"x must be one of {ACT_DTYPES}, got {x.dtype}")
    if n > 65535:
        raise ValueError(f"batch {n} exceeds the kernel's grid limit 65535")


def _check_specs(x, expect: dict, mod_names) -> None:
    """Each `name: (tensor, dtype, shape)` of `expect` on x's device (the
    current one), of that type and shape, 16-byte aligned and contiguous;
    the `mod_names` ones may instead be row views of one modulation tensor
    (one shared row stride, a multiple of 4)."""
    mods = [expect[m][0] for m in mod_names if m in expect]
    for name, (a, dtype, shape) in expect.items():
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {shape}")
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if name in mod_names:
            if a.stride() != mods[0].stride() or a.stride(1) != 1 or a.stride(0) % 4:
                raise ValueError(
                    f"{'/'.join(mod_names)} need one shared row stride, a multiple "
                    f"of 4, and unit column stride; {name} has {a.stride()}"
                )
        elif not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _check_kernel_inputs(x, shift, scale, gate, w1p, b1, w2p, b2, matmul_dtype,
                         w_dtype=torch.bfloat16, **scales) -> None:
    """`w_dtype`: the packed weights' type, bf16 or int8 (then `scales`
    holds s1 and s2)."""
    n, t, d = x.shape
    hdim = w2p.shape[0]
    _check_widths(x, hdim, matmul_dtype)
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
    _check_specs(x, expect, ("shift", "scale", "gate"))


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


def _bwd_error(lib, err: int, stage: str) -> RuntimeError:
    return RuntimeError(f"adaln_mlp_bwd_{stage} kernel launch failed: CUDA error {err} "
                        f"({lib.adaln_mlp_bwd_error_string(err).decode()})")


def adaln_mlp_bwd_prologue(g, mlp, a, gate, w2p, matmul_dtype: torch.dtype = torch.bfloat16):
    """The fused backward's first stage: the inputs of
    `adaln_mlp_bwd_prologue_reference`, with fc2's weight packed by
    `pack_weights` (w2p (H, D + ROW_PAD), bf16 on the card; gate may be a
    row view of the modulation tensor). Returns (da, gelu(a), dmlp, dgate,
    db1, db2)."""
    _check_device(g)
    n, t, d = g.shape
    if g.device.type == "cpu":
        return adaln_mlp_bwd_prologue_reference(g, mlp, a, gate, w2p[:, :d], matmul_dtype)
    hdim = w2p.shape[0]
    _check_widths(g, hdim, matmul_dtype)
    _check_specs(g, {
        "g": (g, g.dtype, (n, t, d)), "mlp": (mlp, torch.float32, (n, t, d)),
        "a": (a, g.dtype, (n, t, hdim)), "gate": (gate, torch.float32, (n, d)),
        "w2p": (w2p, torch.bfloat16, (hdim, d + ROW_PAD)),
    }, ("gate",))
    split = hidden_split(n, t, hdim, _sm_count(g.device.index))
    tiles = -(-t // ROW_TILE)
    ws = torch.empty(n * tiles * (2 * d + hdim), device=g.device, dtype=torch.float32)
    da = torch.empty_like(a)
    gelu_out = torch.empty_like(a)
    dmlp = torch.empty_like(g)
    dgate = torch.empty((n, d), device=g.device, dtype=torch.float32)
    db1 = torch.empty(hdim, device=g.device, dtype=torch.float32)
    db2 = torch.empty(d, device=g.device, dtype=torch.float32)
    lib = _bwd_lib()
    err = lib.adaln_mlp_bwd_prologue(
        g.data_ptr(), mlp.data_ptr(), a.data_ptr(), gate.data_ptr(), gate.stride(0),
        w2p.data_ptr(), da.data_ptr(), gelu_out.data_ptr(), dmlp.data_ptr(), dgate.data_ptr(),
        db1.data_ptr(), db2.data_ptr(), ws.data_ptr(), n, t, d, hdim, split,
        int(g.dtype == torch.bfloat16), torch.cuda.current_stream(g.device).cuda_stream,
    )
    if err:
        raise _bwd_error(lib, err, "prologue")
    adaln_mlp_bwd_prologue.launches += 1
    return da, gelu_out, dmlp, dgate, db1, db2


def adaln_mlp_bwd_epilogue(da, x, g, shift, scale, w1p, eps: float = 1e-6,
                           matmul_dtype: torch.dtype = torch.bfloat16):
    """The fused backward's second stage: the inputs of
    `adaln_mlp_bwd_epilogue_reference`, with fc1's weight packed by
    `pack_weights` (w1p (H / 128, D, 128 + ROW_PAD), bf16 on the card).
    Returns (dx, h1, dshift, dscale)."""
    _check_device(x)
    n, t, d = x.shape
    if x.device.type == "cpu":
        w1 = w1p[..., :HIDDEN_CHUNK].permute(1, 0, 2).reshape(d, -1)
        return adaln_mlp_bwd_epilogue_reference(da, x, g, shift, scale, w1, eps, matmul_dtype)
    hdim = w1p.shape[0] * HIDDEN_CHUNK
    _check_widths(x, hdim, matmul_dtype)
    _check_specs(x, {
        "da": (da, x.dtype, (n, t, hdim)), "x": (x, x.dtype, (n, t, d)),
        "g": (g, x.dtype, (n, t, d)), "shift": (shift, torch.float32, (n, d)),
        "scale": (scale, torch.float32, (n, d)),
        "w1p": (w1p, torch.bfloat16, (hdim // HIDDEN_CHUNK, d, HIDDEN_CHUNK + ROW_PAD)),
    }, ("shift", "scale"))
    ws = torch.empty(2 * n * -(-t // ROW_TILE) * d, device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    h1 = torch.empty_like(x)
    dshift = torch.empty((n, d), device=x.device, dtype=torch.float32)
    dscale = torch.empty((n, d), device=x.device, dtype=torch.float32)
    lib = _bwd_lib()
    err = lib.adaln_mlp_bwd_epilogue(
        da.data_ptr(), x.data_ptr(), g.data_ptr(), shift.data_ptr(), scale.data_ptr(),
        shift.stride(0), w1p.data_ptr(), dx.data_ptr(), h1.data_ptr(), dshift.data_ptr(),
        dscale.data_ptr(), ws.data_ptr(), n, t, d, hdim, eps, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise _bwd_error(lib, err, "epilogue")
    adaln_mlp_bwd_epilogue.launches += 1
    return dx, h1, dshift, dscale


def adaln_mlp_bwd_fused(
    x, shift, scale, gate, fc1_w, fc2_w, a, mlp, g, eps: float = 1e-6,
    matmul_dtype: torch.dtype = torch.float32, packed=None,
):
    """The fused backward (JAX `_bwd_fused_impl`), with the arguments and
    returns of `adaln_mlp_bwd`: the prologue stage, dfc2_w = dmlp^T @
    gelu(a), the epilogue stage, dfc1_w = da^T @ h1. The two weight-gradient
    products stay on cuBLAS (`_mm`), as JAX leaves them to XLA. `packed`:
    (w1p, w2p) of the forward, else fc1_w/fc2_w are packed here."""
    n, t, d = x.shape
    hdim = fc1_w.shape[0]
    w1p, w2p = packed if packed is not None else pack_weights(fc1_w.t(), fc2_w.t(), matmul_dtype)
    g = g.to(x.dtype).contiguous()
    da, gelu_out, dmlp, dgate, db1, db2 = adaln_mlp_bwd_prologue(g, mlp, a, gate, w2p, matmul_dtype)
    dfc2_w = _mm(dmlp.reshape(n * t, d).t(), gelu_out.reshape(n * t, hdim), matmul_dtype)
    dx, h1, dshift, dscale = adaln_mlp_bwd_epilogue(da, x, g, shift, scale, w1p, eps, matmul_dtype)
    dfc1_w = _mm(da.reshape(n * t, hdim).t(), h1.reshape(n * t, d), matmul_dtype)
    return (dx, dshift, dscale, dgate, dfc1_w.to(fc1_w.dtype), db1, dfc2_w.to(fc2_w.dtype), db2)


BWD_IMPLS = ("xla", "fused")  # AdalnMlp's backwards, under the JAX package's names


class AdalnMlp(torch.autograd.Function):
    """The MLP half of a DiT block, differentiable: the training forward
    (kernel B with residuals on the card), then `adaln_mlp_bwd`
    (`bwd_impl="xla"`, the JAX default) or `adaln_mlp_bwd_fused`
    (`"fused"`: the two backward kernels on the card).

    fc1_w (H, D) and fc2_w (D, H) are the Linear weights themselves (not a
    cached packed copy, which holds no autograd history): the forward packs
    them and the backward returns their gradients. The fused backward reads
    the forward's packed tiles, kept in ctx (9.4 MB per DiT-B block in bf16)
    rather than packed a second time: keeping them against repacking is not
    measured."""

    @staticmethod
    def forward(ctx, x, shift, scale, gate, fc1_w, b1, fc2_w, b2, eps: float, matmul_dtype,
                bwd_impl: str = "xla"):
        if bwd_impl not in BWD_IMPLS:
            raise ValueError(f"bwd_impl must be one of {BWD_IMPLS}, got {bwd_impl!r}")
        _check_device(x)
        packed = ()
        if x.is_cuda:
            w1p, w2p = pack_weights(fc1_w.t(), fc2_w.t(), matmul_dtype)
            out, a, mlp = adaln_mlp_train(x, shift, scale, gate, w1p, b1, w2p, b2, eps, matmul_dtype)
            if bwd_impl == "fused":
                packed = (w1p, w2p)
        else:
            out, a, mlp = adaln_mlp_train_reference(
                x, shift, scale, gate, fc1_w.t(), b1, fc2_w.t(), b2, eps, matmul_dtype)
        ctx.save_for_backward(x, shift, scale, gate, fc1_w, fc2_w, a, mlp, *packed)
        ctx.args = (eps, matmul_dtype, bwd_impl)
        return out

    @staticmethod
    def backward(ctx, g):
        eps, matmul_dtype, bwd_impl = ctx.args
        res = ctx.saved_tensors
        if bwd_impl == "fused":
            grads = adaln_mlp_bwd_fused(*res[:8], g, eps, matmul_dtype, packed=tuple(res[8:]) or None)
        else:
            grads = adaln_mlp_bwd(*res, g, eps, matmul_dtype)
        return (*grads, None, None, None)


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
adaln_mlp_bwd_prologue.launches = 0
adaln_mlp_bwd_epilogue.launches = 0
