"""int8 weight-only projections for serving: symmetric per-output-channel
quantization, the three projection kernels' wrappers and their plain
PyTorch versions.

Port of osu_diffusion_tpu/ops/pallas_quant.py:
- `quantize_weight`: `quantize_weight`, on torch's (out, in) layout;
- `int8_matmul`: `_kernel` (act(x @ (w_q * s) + b), optional GELU-tanh),
  csrc/int8_matmul.cu's skinny body for few activation rows (the adaLN
  projection of the sampling chain), csrc/adaln_mlp.cu's cast pass and
  Hopper GEMM over int8 codes for wide batches (`adaln_plan` picks the body
  and its walk; `int8_matmul_staged` walks it in plain PyTorch);
- `int8_modulated_matmul`: `_modulated_kernel` (the qkv projection with
  the non-affine LayerNorm and the adaLN shift/scale folded in),
  csrc/adaln_mlp.cu: kernel B's modulate pass and its persistent Hopper
  GEMM over int8 codes (`int8_modulated_matmul_staged` walks its tile
  plan, `qkv_plan`, in plain PyTorch);
- `int8_out_residual`: `_out_residual_kernel` (the out projection with the
  adaLN gate and the residual add folded in), csrc/adaln_mlp.cu: the same
  Hopper GEMM over int8 codes with o as its bf16 A operand
  (`int8_out_residual_staged` walks its tile plan, `out_plan`).

Weights are int8 codes in torch's Linear layout, w_q (M, K) = (out, in),
with a float32 scale per output channel s (M,): w ~= w_q * s[:, None].
Activations are float32 (the serving stream; the out projection's o may
come in bf16, its rounded form); the scale, bias, GELU, gate and residual
apply in f32. The kernels multiply bf16-rounded activations by
the int8 codes upcast to bf16 (exact, |q| <= 127) with f32 accumulation and
apply the scale to the sum, as the TPU kernels do. The plain versions take
`matmul_dtype`: bfloat16 rounds as the kernels do; float32 is the f32 math
over the dequantised weight w_q * s.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel or raises. Each kernel launch adds one to its wrapper's `.launches`
(the Sampler's CUDA graphs count their captured launches there on each
replay, and not at capture: sampling.py).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from osu_diffusion_tpu_torch.ops import cuda_build
from osu_diffusion_tpu_torch.ops.gemm_plan import GEMM_ROWS, SERVE_WIDTHS, GemmPlan, gemm_plan

K_CHUNK = 64  # the kernels walk K in chunks of this depth
MAX_K = 2048  # the deepest K the kernels take (the skinny body holds x's K part in shared memory)
MATMUL_DTYPES = (torch.bfloat16, torch.float32)
QKV_STAGES = 3  # int8_modulated_matmul's kernels (a mask): 1 the modulate pass, 2 the GEMM


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a (..., out, in)
    weight: scale = absmax / 127 over each output row (1.0 where the row is
    all zero), w_q = round(w / scale), half to even. Returns (w_q int8 of
    w's shape, scale float32 (..., out))."""
    w = w.to(torch.float32)
    absmax = w.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    return torch.round(w / scale[..., None]).to(torch.int8), scale


def dequant_matmul(a: torch.Tensor, w_q: torch.Tensor, s: torch.Tensor,
                   matmul_dtype: torch.dtype) -> torch.Tensor:
    """a (..., K) @ (w_q (M, K) * s[:, None]).T in f32. bfloat16: a rounded
    to bf16, multiplied by the exact int8 codes, the scale applied to the
    f32 sum (the kernels' rounding); float32: the dequantised weight in f32."""
    if matmul_dtype not in MATMUL_DTYPES:
        raise ValueError(f"matmul_dtype must be one of {MATMUL_DTYPES}, got {matmul_dtype}")
    a = a.to(torch.float32)
    if matmul_dtype == torch.float32:
        return torch.matmul(a, (w_q.to(torch.float32) * s[:, None]).t())
    a = a.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(a, w_q.to(torch.float32).t()) * s


def _layer_norm_f32(x: torch.Tensor, eps: float) -> torch.Tensor:
    """The non-affine two-pass LayerNorm, in f32."""
    xf = x.to(torch.float32)
    xc = xf - xf.mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)


def int8_matmul_reference(x, w_q, s, b, activation: str | None = None,
                          matmul_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of `int8_matmul`: act(x @ (w_q * s).T + b)."""
    y = dequant_matmul(x, w_q, s, matmul_dtype) + b
    return F.gelu(y, approximate="tanh") if activation == "gelu_tanh" else y


# int8_matmul: the skinny body (csrc/int8_matmul.cu) for few rows, the int8
# GEMM (csrc/adaln_mlp.cu, int8_matmul_wide_fwd) for wider batches at an
# even M. On an H100 at w (4608, 768) the skinny body beat the wide one up
# to 96 rows and lost at 128 (tools/adaln_proj_variants.py, PERF.md).
SKINNY_ROWS = 96  # the most activation rows the skinny body takes at an even M
SKINNY_WIDTHS = (16, 32, 64)  # weight rows (output columns) a skinny CTA owns
SKINNY_ROW_BLOCKS = (8, 16, 32, 64)  # activation rows of a CTA: 1, 2, 4 or 8 n8 tiles
SKINNY_MT = 16  # weight rows of one mma m-tile
SKINNY_K_WARPS = 4  # warps per m-tile, warp kg taking every 4th slab from kg
SMEM_LIMIT = 232448  # dynamic shared memory a CTA may take on an H100
SMEM_PER_SM = 233472  # shared memory of an H100 SM, 1 KB of it reserved per resident CTA
SKINNY_CTAS_PER_SM = 2  # the most 512-thread skinny CTAs an SM holds (their registers)


def skinny_smem_bytes(k: int, cw: int, row_block: int) -> int:
    """A skinny CTA's dynamic shared memory, as csrc/int8_matmul.cu's Layout:
    its codes or, over them once the products are done, every warp's
    partial sums, whichever is larger; x's rows in bf16 (rows 8 elements
    longer); a barrier a slab and 128 bytes of alignment slack."""
    slabs = k // K_CHUNK
    warps = cw // SKINNY_MT * SKINNY_K_WARPS
    partials = warps * (row_block // 8) * 4 * 32 * 4
    return max(slabs * cw * K_CHUNK, partials) + row_block * (k + 8) * 2 + slabs * 8 + 128


def skinny_resident(k: int, cw: int, row_block: int, sm_count: int) -> int:
    """How many skinny CTAs the card holds at once: as many an SM as shared
    memory allows, SKINNY_CTAS_PER_SM at most."""
    per_sm = SMEM_PER_SM // (skinny_smem_bytes(k, cw, row_block) + 1024)
    return sm_count * min(per_sm, SKINNY_CTAS_PER_SM)


class AdalnPlan(NamedTuple):
    """How `int8_matmul` computes out (rows, M) = act(x (rows, K) . (w_q *
    s)^T + b). Body "sm90_skinny" (csrc/int8_matmul.cu): CTA (c, r) of a
    `grid` of (col_slabs, row_blocks) owns output columns c * cw .. + cw
    and activation rows r * row_block .. + row_block; in it warp (mt, kg)
    multiplies m-tile mt's 16 columns over the slabs `warp_slabs(kg)`, and
    warp (mt, 0) sums the partials warp by warp. Body "sm90" (wide
    batches): `gemm`, the int8 GEMM's tile plan over bf16(x)."""
    body: str
    rows: int
    k: int
    m: int
    cw: int = 0
    row_block: int = 0
    gemm: GemmPlan | None = None

    @property
    def col_slabs(self) -> int:
        return -(-self.m // self.cw)

    @property
    def row_blocks(self) -> int:
        return -(-self.rows // self.row_block)

    @property
    def grid(self) -> tuple[int, int]:
        return self.col_slabs, self.row_blocks

    @property
    def ctas(self) -> int:
        return self.gemm.grid if self.gemm is not None else self.grid[0] * self.grid[1]

    @property
    def smem_bytes(self) -> int:
        return skinny_smem_bytes(self.k, self.cw, self.row_block)

    def warp_slabs(self, kg: int) -> range:
        """The 64-deep slabs warp kg of an m-tile multiplies, in order."""
        return range(kg, self.k // K_CHUNK, SKINNY_K_WARPS)


def skinny_width(rows: int) -> int:
    """A skinny CTA's width: every CTA reads all of x's rows, so the CTAs
    together read x (rows x K f32) once per `cw` columns; the narrowest
    width (the most CTAs in flight) at which that stays within half the
    weight's bytes, cw >= 8 rows, 64 at most. (On an H100 at w (4608, 768):
    16 columns fastest at 2 rows, 64 from 8 rows on.)"""
    return next((w for w in SKINNY_WIDTHS if w >= 8 * rows), SKINNY_WIDTHS[-1])


@functools.cache
def adaln_plan(rows: int, k: int, m: int, sm_count: int, cw: int | None = None) -> AdalnPlan:
    """The body and walk of `int8_matmul` (cached: the host path adds
    nothing). More than SKINNY_ROWS rows at an even M take the int8 GEMM
    (its epilogue stores column pairs); the rest the skinny body, its CTAs
    `skinny_width` columns wide (unless `cw` is given), its row block the
    fewest n8 tiles that hold the rows (at most 64, fewer where x's K would
    overflow shared memory), halved down to 16 while the grid stays within
    what the card holds at once (`skinny_resident`): more, smaller CTAs
    share the products and x's loads (on an H100 at w (4608, 768): 64 rows
    0.0152 ms in one 72-CTA wave of 64-row blocks, 0.0132 in 32-row
    ones)."""
    if k % K_CHUNK or not K_CHUNK <= k <= MAX_K:
        raise ValueError(f"the kernels take K a multiple of {K_CHUNK} up to {MAX_K}, got {k}")
    if rows < 1 or m < 1:
        raise ValueError(f"no rows or columns: rows {rows}, M {m}")
    if rows > SKINNY_ROWS and m % 2 == 0:
        return AdalnPlan("sm90", rows, k, m, gemm=gemm_plan(rows, m, k, sm_count, ragged=True))
    cw = skinny_width(rows) if cw is None else cw
    if cw not in SKINNY_WIDTHS:
        raise ValueError(f"the skinny body takes CTA widths {SKINNY_WIDTHS}, got {cw}")
    row_block = next(r for r in SKINNY_ROW_BLOCKS if r >= min(rows, SKINNY_ROW_BLOCKS[-1]))
    while row_block > SKINNY_ROW_BLOCKS[0] and skinny_smem_bytes(k, cw, row_block) > SMEM_LIMIT:
        row_block //= 2
    col_slabs = -(-m // cw)
    while (row_block > SKINNY_ROW_BLOCKS[1]
           and col_slabs * -(-rows // (row_block // 2))
           <= skinny_resident(k, cw, row_block // 2, sm_count)):
        row_block //= 2
    plan = AdalnPlan("sm90_skinny", rows, k, m, cw, row_block)
    if plan.row_blocks > 65535:
        raise ValueError(f"{rows} rows exceed the skinny body's grid")
    return plan


def _gemm_walk(a, w_q, s, b, plan: GemmPlan) -> torch.Tensor:
    """The int8 GEMM (csrc/gemm_sm90.cuh B_INT8) in plain PyTorch: a (rows,
    depth) f32 holding bf16 values, times each tile's codes upcast exactly
    (rows past M read as 0, as TMA reads them), tile by tile in the order
    each CTA of `plan` walks them, the whole reduction summed before the
    epilogue takes acc * s + b and stores the columns below M. A tile no CTA
    computes stays NaN. Returns (rows, M) f32."""
    f32 = torch.float32
    rows, m = a.shape[0], w_q.shape[0]
    codes = F.pad(w_q.to(f32), (0, 0, 0, plan.tiles_n * plan.width - m))
    out = torch.full((rows, m), float("nan"))
    for cta in range(plan.grid):
        for r0, c0 in plan.tiles_of(cta):
            rs, width = slice(r0, r0 + GEMM_ROWS), min(plan.width, m - c0)
            acc = a[rs] @ codes[c0:c0 + plan.width].t()
            cols = slice(c0, c0 + width)
            out[rs, cols] = acc[:, :width] * s[cols] + b[cols]
    return out


def int8_matmul_staged(x, w_q, s, b, activation: str | None, plan: AdalnPlan) -> torch.Tensor:
    """The kernels of `int8_matmul` in plain PyTorch, walking `plan`
    (`adaln_plan`). Skinny: for each CTA's column slab and row block, each
    warp's slabs multiplied (bf16(x) times the exact codes, columns past M
    read as 0), the warps' partial sums added in the kernel's fixed order
    (warp by warp), then acc * s
    + b and GELU-tanh on the columns below M. Wide: bf16(x), then the int8
    GEMM's tile walk with the GELU after it. Columns no CTA computes stay
    NaN. Returns (..., M) as `int8_matmul_reference` at bf16 operands."""
    f32 = torch.float32
    k, m = x.shape[-1], w_q.shape[0]
    a = x.reshape(-1, k).to(f32).to(torch.bfloat16).to(f32)
    if plan.body == "sm90":
        out = _gemm_walk(a, w_q, s, b, plan.gemm)
    else:
        cw, rb = plan.cw, plan.row_block
        codes = F.pad(w_q.to(f32), (0, 0, 0, plan.col_slabs * cw - m))
        out = torch.full((a.shape[0], m), float("nan"))
        for c0 in range(0, plan.col_slabs * cw, cw):
            width = min(cw, m - c0)
            for r0 in range(0, plan.rows, rb):
                rows = slice(r0, r0 + rb)
                acc = None
                for kg in range(SKINNY_K_WARPS):
                    part = torch.zeros(a[rows].shape[0], cw)
                    for j in plan.warp_slabs(kg):
                        ks = slice(j * K_CHUNK, (j + 1) * K_CHUNK)
                        part = part + a[rows, ks] @ codes[c0:c0 + cw, ks].t()
                    acc = part if acc is None else acc + part
                cols = slice(c0, c0 + width)
                out[rows, cols] = acc[:, :width] * s[cols] + b[cols]
    if activation == "gelu_tanh":
        out = F.gelu(out, approximate="tanh")
    return out.reshape(*x.shape[:-1], m)


def int8_modulated_matmul_reference(x, shift, scale, w_q, s, b, eps: float = 1e-6,
                                    matmul_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of `int8_modulated_matmul`:
    (LN(x) * (1 + scale) + shift) @ (w_q * s).T + b."""
    h = _layer_norm_f32(x, eps) * (1.0 + scale[:, None, :]) + shift[:, None, :]
    return dequant_matmul(h, w_q, s, matmul_dtype) + b


def qkv_plan(n: int, t: int, d: int, m: int, sm_count: int) -> GemmPlan:
    """The tile plan of `int8_modulated_matmul`'s GEMM over the N*T token
    rows: M columns over a depth of D, the last column block ragged where
    the tile width does not divide M."""
    return gemm_plan(n * t, m, d, sm_count, ragged=True)


def int8_modulated_matmul_staged(x, shift, scale, w_q, s, b, eps: float,
                                 plan: GemmPlan) -> torch.Tensor:
    """The kernel's stages in plain PyTorch: the modulate pass (h in bf16),
    then the GEMM tile by tile in the order each CTA of `plan` (`qkv_plan`)
    walks them, each tile's codes upcast exactly (rows past M read as 0,
    as TMA reads them) and its whole reduction summed before the epilogue
    takes acc * s + b and stores the columns below M. Returns (N, T, M) as
    `int8_modulated_matmul_reference` at bf16 operands."""
    n, t, d = x.shape
    h = _layer_norm_f32(x, eps) * (1.0 + scale[:, None, :]) + shift[:, None, :]
    h = h.reshape(n * t, d).to(torch.bfloat16).to(torch.float32)
    return _gemm_walk(h, w_q, s, b, plan).reshape(n, t, w_q.shape[0])


def int8_out_residual_reference(o, res, gate, w_q, s, b,
                                matmul_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of `int8_out_residual`: res + gate * (o @ (w_q * s).T + b)."""
    return res + gate[:, None, :] * (dequant_matmul(o, w_q, s, matmul_dtype) + b)


def out_plan(n: int, t: int, d: int, sm_count: int) -> GemmPlan:
    """The tile plan of `int8_out_residual`'s GEMM over the N*T token rows:
    D columns over a depth of D, whole column blocks (its epilogue reads
    res and gate a column pair at a time up to D)."""
    return gemm_plan(n * t, d, d, sm_count)


def int8_out_residual_staged(o, res, gate, w_q, s, b, plan: GemmPlan) -> torch.Tensor:
    """The kernel in plain PyTorch: the GEMM tile by tile in the order each
    CTA of `plan` (`out_plan`) walks them, bf16(o) times each tile's codes
    upcast exactly, the whole reduction summed before the epilogue takes y
    = acc * s + b and res + gate[row / T] * y (a 128-row block may span two
    batch rows). Returns (N, T, D) as `int8_out_residual_reference` at bf16
    operands."""
    f32 = torch.float32
    n, t, d = res.shape
    a = o.reshape(n * t, d).to(f32).to(torch.bfloat16).to(f32)
    codes = w_q.to(f32)
    batch = torch.arange(n * t) // t  # the batch row of each token row
    res2, out = res.reshape(n * t, d), torch.full((n * t, d), float("nan"))
    for cta in range(plan.grid):
        for r0, c0 in plan.tiles_of(cta):
            rows, cols = slice(r0, r0 + GEMM_ROWS), slice(c0, c0 + plan.width)
            y = a[rows] @ codes[cols].t() * s[cols] + b[cols]
            out[rows, cols] = res2[rows, cols] + gate[batch[rows], cols] * y
    return out.reshape(n, t, d)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The skinny body of `int8_matmul`."""
    lib = cuda_build.load_library("int8_matmul")
    fn = lib.int8_matmul_skinny_fwd
    fn.restype = ctypes.c_int
    # (x, w, s, b, out, rows, k, m, gelu, cw, row_block, stream)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.int8_matmul_skinny_smem_bytes.restype = ctypes.c_int
    lib.int8_matmul_skinny_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.int8_matmul_error_string.restype = ctypes.c_char_p
    lib.int8_matmul_error_string.argtypes = [ctypes.c_int]
    lib.int8_matmul_last_body.restype = ctypes.c_char_p
    return lib


@functools.cache
def _gemm_lib() -> ctypes.CDLL:
    """The adaLN-MLP library, whose modulate pass and Hopper GEMM compute
    `int8_modulated_matmul`, whose Hopper GEMM computes `int8_out_residual`,
    and whose cast pass and Hopper GEMM compute `int8_matmul` on wide
    batches."""
    lib = cuda_build.load_library("adaln_mlp")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, argtypes in {
        # (x, shift, scale, mod_stride, w, s, b, h, out, n, t, d, m, bn, grid, eps, stages, stream)
        "int8_modulated_matmul_fwd": [p] * 3 + [ll] + [p] * 5 + [i] * 6 + [ctypes.c_float, i, p],
        # (o, res, gate, gate_stride, w, s, b, out, n, t, d, bn, grid, stream)
        "int8_out_residual_fwd": [p] * 3 + [ll] + [p] * 4 + [i] * 5 + [p],
        # (x, w, s, b, xb, out, rows, k, m, gelu, bn, grid, stream)
        "int8_matmul_wide_fwd": [p] * 6 + [i] * 6 + [p],
    }.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    lib.adaln_mlp_error_string.restype = ctypes.c_char_p
    lib.adaln_mlp_error_string.argtypes = [ctypes.c_int]
    lib.adaln_mlp_last_body.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check_input(x: torch.Tensor, what: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 activations (the serving stream), got {x.dtype}")


def _check_kernel_inputs(matmul_dtype, k: int, max_k: int, w_q, **tensors) -> None:
    """Types, shapes (checked by the caller), contiguity, alignment and the
    widths the kernels are built for; `tensors` are f32, their first the
    activation."""
    if matmul_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernels compute with bf16 operands; "
                         f"matmul_dtype={matmul_dtype} has no kernel")
    if k % K_CHUNK or not K_CHUNK <= k <= max_k:
        raise ValueError(f"the kernels take K a multiple of {K_CHUNK} up to {max_k}, got {k}")
    first = next(iter(tensors.values()))
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, got {w_q.dtype}")
    for name, a in {"w_q": w_q, **tensors}.items():
        if a.device != first.device:
            raise ValueError(f"{name} is on {a.device}, the activation on {first.device}")
        if name != "w_q" and a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if name in ("shift", "scale", "gate"):
            if a.stride(1) != 1 or a.stride(0) % 4 or a.stride() != tensors.get("shift", a).stride():
                raise ValueError("shift/scale/gate need one shared row stride, a multiple of 4, "
                                 f"and unit column stride; {name} has {a.stride()}")
        elif not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if first.device.index != torch.cuda.current_device():
        raise ValueError(f"the activation is on {first.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _check_shapes(w_q, s, b, k: int) -> int:
    if w_q.ndim != 2 or w_q.shape[1] != k:
        raise ValueError(f"w_q must be (M, {k}), got {tuple(w_q.shape)}")
    m = w_q.shape[0]
    if tuple(s.shape) != (m,) or tuple(b.shape) != (m,):
        raise ValueError(f"scale and bias must be ({m},), got {tuple(s.shape)} and {tuple(b.shape)}")
    return m


def _adaln_launch(x2, w_q, s, b, activation: str | None, plan: AdalnPlan) -> torch.Tensor:
    """`int8_matmul`'s kernels on x2's (rows, K) device as `plan` says.
    Records the body in `.body`."""
    rows, k = x2.shape
    m = w_q.shape[0]
    out = torch.empty((rows, m), device=x2.device, dtype=torch.float32)
    gelu = int(activation == "gelu_tanh")
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    ptrs = (x2.data_ptr(), w_q.data_ptr(), s.data_ptr(), b.data_ptr())
    if plan.body == "sm90_skinny":
        lib = _lib()
        err = lib.int8_matmul_skinny_fwd(*ptrs, out.data_ptr(), rows, k, m, gelu, plan.cw,
                                         plan.row_block, stream)
        error_string, last_body = lib.int8_matmul_error_string, lib.int8_matmul_last_body
    else:
        xb = torch.empty((rows, k), device=x2.device, dtype=torch.bfloat16)
        lib = _gemm_lib()
        err = lib.int8_matmul_wide_fwd(*ptrs, xb.data_ptr(), out.data_ptr(), rows, k, m, gelu,
                                       plan.gemm.width, plan.gemm.grid, stream)
        error_string, last_body = lib.adaln_mlp_error_string, lib.adaln_mlp_last_body
    if err:
        raise RuntimeError(f"int8_matmul kernel launch failed: error {err} "
                           f"({error_string(err).decode()})")
    int8_matmul.body = last_body().decode()
    return out


def int8_matmul(x, w_q, s, b, activation: str | None = None,
                matmul_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """act(x @ (w_q * s).T + b), reading w_q as int8. x: (..., K) f32;
    w_q: (M, K) int8; s, b: (M,) f32; `activation`: None or "gelu_tanh".
    Returns (..., M) f32. On the card `adaln_plan` picks the body (and
    refuses a K the kernels do not take: not a multiple of 64, or past
    MAX_K); a CPU tensor takes the plain version at any K."""
    if activation not in (None, "gelu_tanh"):
        raise ValueError(f"unknown activation: {activation}")
    _check_input(x, "int8_matmul")
    k = x.shape[-1]
    m = _check_shapes(w_q, s, b, k)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, s, b, activation, matmul_dtype)
    x2 = x.reshape(-1, k)
    _check_kernel_inputs(matmul_dtype, k, MAX_K, w_q, x=x2, s=s, b=b)
    plan = adaln_plan(x2.shape[0], k, m, _sm_count(x.device.index))
    out = _adaln_launch(x2, w_q, s, b, activation, plan)
    int8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], m)


def _modulated_launch(x, shift, scale, w_q, s, b, eps: float, matmul_dtype,
                      stages: int = QKV_STAGES) -> torch.Tensor:
    """`int8_modulated_matmul`'s two kernels on x's device; `stages` below
    QKV_STAGES runs only those (a timing run; the others' outputs left
    unwritten). Records the body in `.body`."""
    n, t, d = x.shape
    m = w_q.shape[0]
    for name, a in (("shift", shift), ("scale", scale)):
        if tuple(a.shape) != (n, d):
            raise ValueError(f"{name} must be ({n}, {d}), got {tuple(a.shape)}")
    if d not in SERVE_WIDTHS:
        raise ValueError(f"the kernel takes D in {SERVE_WIDTHS}, got {d}")
    if m % 2:
        raise ValueError(f"the kernel takes an even M, got {m}")
    _check_kernel_inputs(matmul_dtype, d, MAX_K, w_q, x=x, shift=shift, scale=scale, s=s, b=b)
    plan = qkv_plan(n, t, d, m, _sm_count(x.device.index))
    h = torch.empty((n * t, d), device=x.device, dtype=torch.bfloat16)
    out = torch.empty((n, t, m), device=x.device, dtype=torch.float32)
    lib = _gemm_lib()
    err = lib.int8_modulated_matmul_fwd(
        x.data_ptr(), shift.data_ptr(), scale.data_ptr(), shift.stride(0), w_q.data_ptr(),
        s.data_ptr(), b.data_ptr(), h.data_ptr(), out.data_ptr(), n, t, d, m, plan.width,
        plan.grid, eps, stages, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        msg = lib.adaln_mlp_error_string(err).decode()
        raise RuntimeError(f"int8_modulated_matmul kernel launch failed: error {err} ({msg})")
    int8_modulated_matmul.body = lib.adaln_mlp_last_body().decode()
    return out


def int8_modulated_matmul(x, shift, scale, w_q, s, b, eps: float = 1e-6,
                          matmul_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(LN(x) * (1 + scale) + shift) @ (w_q * s).T + b with a non-affine
    two-pass LayerNorm, reading w_q as int8. x: (N, T, D) f32; shift,
    scale: (N, D) f32 (row views of one modulation tensor are fine);
    w_q: (M, D) int8; s, b: (M,) f32. Returns (N, T, M) f32. The kernel
    takes D in SERVE_WIDTHS and an even M."""
    _check_input(x, "int8_modulated_matmul")
    d = x.shape[-1]
    _check_shapes(w_q, s, b, d)
    if x.device.type == "cpu":
        return int8_modulated_matmul_reference(x, shift, scale, w_q, s, b, eps, matmul_dtype)
    out = _modulated_launch(x, shift, scale, w_q, s, b, eps, matmul_dtype)
    int8_modulated_matmul.launches += 1
    return out


def int8_out_residual(o, res, gate, w_q, s, b,
                      matmul_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """res + gate * (o @ (w_q * s).T + b), reading w_q as int8. o: (N, T,
    D) bf16 (the banded attention's `out_dtype`) or f32; res: (N, T, D)
    f32; gate: (N, D) f32 (a row view is fine); w_q: (D, D) int8; s, b:
    (D,) f32. Returns (N, T, D) f32. The kernel multiplies bf16(o): on the
    card an f32 o is first rounded to a bf16 copy (the contract's own
    rounding, for callers with no bf16 o; each such copy adds one to
    `.o_casts`). The kernel takes D a multiple of 128."""
    _check_input(res, "int8_out_residual")
    if o.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"o must be float32 or bfloat16, got {o.dtype}")
    n, t, d = res.shape
    if _check_shapes(w_q, s, b, d) != d:
        raise ValueError(f"w_q must be ({d}, {d}), got {tuple(w_q.shape)}")
    if o.device.type == "cpu":
        return int8_out_residual_reference(o, res, gate, w_q, s, b, matmul_dtype)
    if tuple(o.shape) != (n, t, d) or tuple(gate.shape) != (n, d):
        raise ValueError(f"o must be ({n}, {t}, {d}) and gate ({n}, {d}), got "
                         f"{tuple(o.shape)} and {tuple(gate.shape)}")
    if o.device != res.device:
        raise ValueError(f"o is on {o.device}, res on {res.device}")
    if o.dtype == torch.float32:
        o = o.to(torch.bfloat16)
        int8_out_residual.o_casts += 1
    if not o.is_contiguous() or o.data_ptr() % 16:
        raise ValueError("o must be contiguous and 16-byte aligned (the GEMM's TMA-loaded A)")
    _check_kernel_inputs(matmul_dtype, d, MAX_K, w_q, res=res, gate=gate, s=s, b=b)
    plan = out_plan(n, t, d, _sm_count(res.device.index))
    out = torch.empty_like(res)
    lib = _gemm_lib()
    err = lib.int8_out_residual_fwd(
        o.data_ptr(), res.data_ptr(), gate.data_ptr(), gate.stride(0), w_q.data_ptr(), s.data_ptr(),
        b.data_ptr(), out.data_ptr(), n, t, d, plan.width, plan.grid,
        torch.cuda.current_stream(res.device).cuda_stream)
    if err:
        msg = lib.adaln_mlp_error_string(err).decode()
        raise RuntimeError(f"int8_out_residual kernel launch failed: error {err} ({msg})")
    int8_out_residual.body = lib.adaln_mlp_last_body().decode()
    int8_out_residual.launches += 1
    return out


int8_matmul.launches = 0
int8_modulated_matmul.launches = 0
int8_out_residual.launches = 0
int8_out_residual.o_casts = 0  # f32 o rounded to a bf16 copy before a launch
int8_matmul.body = None
int8_modulated_matmul.body = None
int8_out_residual.body = None
# the wrappers whose `.launches` count kernel launches (sampling.py adds a
# CUDA graph's captured launches, and o_casts, to them on each replay)
WRAPPERS = (int8_matmul, int8_modulated_matmul, int8_out_residual)
