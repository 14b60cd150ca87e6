"""Time variants of the int8 adaLN projection (row 13, `int8_matmul`) on the
card, in turns.

Builds copies of csrc/int8_matmul.cu side by side (one nvcc each, into the
package's build directory): the committed skinny body (every slab of the
CTA's codes by TMA at its start, mma.sync over codes upcast in registers),
one whose x prologue issues 8 loads a thread before their stores (`xb8`),
one in which each CTA starts its walk over x at its own offset
(`stagger`: CTA c at c / grid of x, wrapping round), one that requests the
slabs with cp.async.bulk, a 64-byte copy per weight row and slab
(`bulk`), one in which each warp loads the codes of all its slabs straight
into registers at its start (`ldg`: no TMA, no barriers, no shared memory
for the codes), one that multiplies with f32 FMAs instead of mma.sync
(`fma`: each thread's 16 codes of two weight rows times x's bf16 values,
the four lanes of a row group summed by shuffles), and two diagnostics
whose results are wrong and go unchecked (`x_row0`: every row of x read
from the block's row 0, so L2 serves 1 / rows of x's bytes; `no_x`: no x
prologue); with `--baseline DIR`, also the int8_matmul.cu of another
checkout at DIR (the parent's WMMA body, its grid from the parent's
`tiles_per_cta`), and that checkout's adaln_mlp.cu, through which rows 10,
11 and 12 (whose library gained row 13's wide body) must give the
committed library's bits. With the committed build it runs every CTA
width (16, 32, 64 columns) the kernel takes, row blocks of 16, 32 and 64
from 16 to 128 rows, and the wide body (the cast pass and the int8 GEMM,
csrc/adaln_mlp.cu) where M is even. Times, at the DiT-B adaLN projection
(w (4608, 768) int8) for 2, 8, 16, 32, 48, 64, 96, 128 and 256
activation rows (the skinny body past SKINNY_ROWS too, to place it), at
the DiT-XL one (w (6912, 1152)) for 2 and at w (16, 64) for 2 (one CTA),
each variant back to back (the weight stays in L2) in turns from the first
variant to the last and back; at 2 rows also cold (rotating over
chip_smoke.COLD_COPIES weight copies). Every variant but the diagnostics
must be within chip_smoke.QUANT_TOL_BF16 of the plain version at bf16
operands; those that sum in the committed order (every CTA width and row
block, the x walks, the bulk and register-held codes) must give its bits,
the FMA products' bits are reported. Run from the repository root
on a card:

    python -m osu_diffusion_tpu_torch.tools.adaln_proj_variants [--baseline DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import itertools
import os
import types

import torch

from osu_diffusion_tpu_torch.ops import adaln_mlp as am
from osu_diffusion_tpu_torch.ops import cuda_build
from osu_diffusion_tpu_torch.ops import quant as tq
from osu_diffusion_tpu_torch.ops.gemm_plan import gemm_plan
from osu_diffusion_tpu_torch.tools.mlp_variants import build

# the bulk variant: Params carries the codes' pointer, and warp 0's lanes
# copy each weight row's 64 bytes of a slab (rows below M) with
# cp.async.bulk onto the slab's barrier
REQUEST = """  for (int j = lane; j < nslab; j += 32) sm90::bar_init(&bars[j], 1);
  sm90::bar_init_fence();
  for (int j = lane; j < nslab; j += 32) {
    sm90::bar_expect(&bars[j], cw * SLAB);
    sm90::tma_load_2d(wsm + j * cw * SLAB, w_map, &bars[j], j * SLAB, col0);
  }
"""
BULK_REQUEST = """  for (int j = lane; j < nslab; j += 32) sm90::bar_init(&bars[j], 1);
  sm90::bar_init_fence();
  const int8_t* w = static_cast<const int8_t*>(w_ptr);
  const int valid = min(cw, m - col0);
  for (int j = lane; j < nslab; j += 32) {
    sm90::bar_expect(&bars[j], valid * SLAB);
    for (int r = 0; r < valid; ++r)
      tile_io::bulk_copy(wsm + j * cw * SLAB + r * SLAB,
                         w + (long long)(col0 + r) * k + j * SLAB, SLAB,
                         tile_io::smem_addr(&bars[j]));
  }
"""
BULK_EDITS = (
    (REQUEST, BULK_REQUEST),
    ("__device__ __forceinline__ void request_slabs(const CUtensorMap* w_map, int8_t* wsm,",
     "__device__ __forceinline__ void request_slabs(const void* w_ptr, int k, int m, int8_t* wsm,"),
    ("  if (warp == 0) request_slabs(&w_map, wsm, bars, nslab, col0, p.cw, lane);",
     "  if (warp == 0) request_slabs(p.w, p.k, p.m, wsm, bars, nslab, col0, p.cw, lane);"),
)
# both: Params carries the codes' pointer
W_PARAM = (
    ("  const float* x;  // (rows, k)\n", "  const float* x;  // (rows, k)\n  const void* w;\n"),
    ("  const Params p{x, s, b, out, rows, k, m, cw, row_block, gelu};",
     "  const Params p{x, w, s, b, out, rows, k, m, cw, row_block, gelu};"),
)
# the ldg variant: no TMA, no barriers; each warp requests the 16-byte code
# pieces of every slab it takes into registers at the start (8 slabs a
# warp: K up to 2048), before the x prologue
LDG_EDITS = (
    ("  if (warp == 0) request_slabs(&w_map, wsm, bars, nslab, col0, p.cw, lane);\n",
     """  constexpr int HELD = 8;
  uint4 held_lo[HELD], held_hi[HELD];
  {
    const int8_t* w = static_cast<const int8_t*>(p.w);
    const int r_lo = col0 + mt * MT_ROWS + g, r_hi = r_lo + 8;
#pragma unroll
    for (int u = 0; u < HELD; ++u) {
      const int j = kg + u * K_WARPS;
      held_lo[u] = held_hi[u] = make_uint4(0u, 0u, 0u, 0u);
      if (j < nslab) {
        const long long off = (long long)j * SLAB + 16 * q;
        if (r_lo < p.m) held_lo[u] = __ldg(reinterpret_cast<const uint4*>(w + (long long)r_lo * p.k + off));
        if (r_hi < p.m) held_hi[u] = __ldg(reinterpret_cast<const uint4*>(w + (long long)r_hi * p.k + off));
      }
    }
  }
"""),
    ("""  for (int j = kg; j < nslab; j += K_WARPS) {
    sm90::bar_wait(&bars[j], 0);
    const int8_t* codes = wsm + j * p.cw * SLAB + mt * MT_ROWS * SLAB + 16 * q;
    slab_product<NT>(acc, *reinterpret_cast<const uint4*>(codes + g * SLAB),
                     *reinterpret_cast<const uint4*>(codes + (g + 8) * SLAB), xs + j * SLAB,
                     lay.ldx, nrows, lane);
  }""", """#pragma unroll
  for (int u = 0; u < HELD; ++u) {
    const int j = kg + u * K_WARPS;
    if (j < nslab) slab_product<NT>(acc, held_lo[u], held_hi[u], xs + j * SLAB, lay.ldx, nrows, lane);
  }"""),
)
MMA = """#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = nt * 8 + g;
    uint4 x0 = make_uint4(0u, 0u, 0u, 0u), x1 = x0;
    if (n < nrows) {
      const __nv_bfloat16* row = xs + n * ldx + 16 * q;
      x0 = *reinterpret_cast<const uint4*>(row);
      x1 = *reinterpret_cast<const uint4*>(row + 8);
    }
    mma_bf16(acc[nt], a[0], x0.x, x0.y);
    mma_bf16(acc[nt], a[1], x0.z, x0.w);
    mma_bf16(acc[nt], a[2], x1.x, x1.y);
    mma_bf16(acc[nt], a[3], x1.z, x1.w);
  }
"""
# the FMA variant: the thread's 16 codes of rows g and g + 8 (k = 16 q ..)
# as floats times x's row n at the same k, the four lanes of the group
# summed by shuffles, each sum added where the mma layout keeps it
FMA = """  float fl[16], fh[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    fl[c] = static_cast<float>(static_cast<signed char>(wl[c / 4] >> (8 * (c % 4))));
    fh[c] = static_cast<float>(static_cast<signed char>(wh[c / 4] >> (8 * (c % 4))));
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      if (nt * 8 + nn >= nrows) continue;
      const __nv_bfloat16* row = xs + (nt * 8 + nn) * ldx + 16 * q;
      float pl = 0.f, ph = 0.f;
#pragma unroll
      for (int c = 0; c < 16; c += 2) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
        pl = fmaf(fl[c], v.x, pl);
        pl = fmaf(fl[c + 1], v.y, pl);
        ph = fmaf(fh[c], v.x, ph);
        ph = fmaf(fh[c + 1], v.y, ph);
      }
      pl += __shfl_xor_sync(0xffffffffu, pl, 1);
      pl += __shfl_xor_sync(0xffffffffu, pl, 2);
      ph += __shfl_xor_sync(0xffffffffu, ph, 1);
      ph += __shfl_xor_sync(0xffffffffu, ph, 2);
      if (nn / 2 == q) {
        acc[nt][nn & 1] += pl;
        acc[nt][2 + (nn & 1)] += ph;
      }
    }
"""
X_LOOP = """  for (int idx = threadIdx.x; idx < nrows * k4; idx += blockDim.x) {
    const int r = idx / k4, c = (idx % k4) * 4;
    tile_io::store4(xs + r * lay.ldx + c, tile_io::load4(p.x + (long long)(row0 + r) * p.k + c));
  }
"""
# the xb8 variant: 8 loads a thread in flight before their stores
XB8_LOOP = """  const int n4 = nrows * k4;
  for (int i0 = threadIdx.x; i0 < n4; i0 += 8 * blockDim.x) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = i0 + u * blockDim.x;
      if (idx < n4) v[u] = tile_io::load4(p.x + (long long)(row0 + idx / k4) * p.k + idx % k4 * 4);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = i0 + u * blockDim.x;
      if (idx < n4) tile_io::store4(xs + idx / k4 * lay.ldx + idx % k4 * 4, v[u]);
    }
  }
"""
# the stagger variant: CTA c starts at c / gridDim.x of x's block, wrapping round
STAGGER_LOOP = """  const int n4 = nrows * k4, rot = (int)((long long)blockIdx.x * n4 / gridDim.x);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const int idx = i + rot < n4 ? i + rot : i + rot - n4;
    const int r = idx / k4, c = (idx % k4) * 4;
    tile_io::store4(xs + r * lay.ldx + c, tile_io::load4(p.x + (long long)(row0 + r) * p.k + c));
  }
"""
# diagnostics, timed with their results unchecked: `x_row0` reads row 0 of
# the block for every row (the same loads, 1 / rows of x's distinct bytes
# from L2; the rest hit L1), `no_x` has no x prologue at all
X_ROW0_LOOP = X_LOOP.replace("p.x + (long long)(row0 + r) * p.k + c", "p.x + (long long)row0 * p.k + c")
DIAGNOSTICS = ("x_row0", "no_x")
ROW_BLOCK_ROWS = (16, 128)  # the row counts at which row blocks of 16, 32 and 64 are timed
# name -> edits of int8_matmul.cu
VARIANTS = {"committed": (), "xb8": ((X_LOOP, XB8_LOOP),), "stagger": ((X_LOOP, STAGGER_LOOP),),
            "bulk": BULK_EDITS + W_PARAM, "ldg": LDG_EDITS + W_PARAM, "fma": ((MMA, FMA),),
            "x_row0": ((X_LOOP, X_ROW0_LOOP),), "no_x": ((X_LOOP, ""),)}
ROWS = (2, 8, 16, 32, 48, 64, 96, 128, 256)
# (rows, K, M): the DiT-B adaLN projection at ROWS, the DiT-XL one, and one
# CTA of one slab (the launch and one CTA's chain of latencies)
CASES = [(r, 768, 4608) for r in ROWS] + [(2, 1152, 6912), (2, 64, 16)]
FMA_ROWS = 16  # the FMA variant is timed up to this many rows (its work grows with them)


def variant_sources(baseline: str | None) -> dict[str, dict[str, str]]:
    def read(path):
        with open(path) as f:
            return f.read()

    src = read(os.path.join(cuda_build.CSRC_DIR, "int8_matmul.cu"))
    sources = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"adaln_proj_variants: {name}'s edit does not match int8_matmul.cu once")
            text = text.replace(old, new)
        sources[name] = {"int8_matmul.cu": text}
    if baseline is not None:
        csrc = os.path.join(baseline, "osu_diffusion_tpu_torch", "csrc")
        sources["baseline"] = {os.path.basename(p): read(p) for p in glob.glob(os.path.join(csrc, "*.cu*"))}
    return sources


def baseline_tiles_per_cta(rows: int, m: int, sm_count: int) -> int:
    """The parent's grid rule for its WMMA body (32-row, 64-column tiles):
    the fewest column tiles a CTA that still give two CTAs an SM."""
    row_tiles, m_tiles = -(-rows // 32), -(-m // 64)
    groups = min(m_tiles, max(1, -(-2 * sm_count // row_tiles)))
    return -(-m_tiles // groups)


def check_gemm_rows_unchanged(baseline: str) -> None:
    """Rows 10, 11 and 12 (the int8 GEMMs of csrc/adaln_mlp.cu, which gained
    row 13's ADA epilogue and cast pass) through the baseline's adaln_mlp.cu
    and the committed one, at the DiT-B sampling shapes: the same bits
    required."""
    libs, _ = build({"baseline": variant_sources(baseline)["baseline"]}, main="adaln_mlp.cu",
                    out="adaln_proj_variants_gemm")
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(17)
    n, t, d = 2, 768, 768

    def codes(m, k):
        return tq.quantize_weight(torch.randn((m, k), generator=g, device=dev) * k ** -0.5)

    x, res = (torch.randn((n, t, d), generator=g, device=dev) for _ in range(2))
    mod = torch.randn((n, 6 * d), generator=g, device=dev) * 0.3
    (w1q, s1), (w2q, s2), (wq, s), (woq, so) = codes(4 * d, d), codes(d, 4 * d), codes(3 * d, d), codes(d, d)
    b1, b2, b = (torch.randn(k, generator=g, device=dev) * 0.02 for k in (4 * d, d, 3 * d))
    o = torch.randn((n, t, d), generator=g, device=dev).to(torch.bfloat16)

    def rows_10_to_12():
        return (am.adaln_mlp_quant(x, mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:], w1q, s1, b1,
                                   w2q, s2, b2),
                tq.int8_modulated_matmul(x, mod[:, :d], mod[:, d:2 * d], wq, s, b),
                tq.int8_out_residual(o, res, mod[:, 2 * d:3 * d], woq, so, b2))

    load = cuda_build.load_library
    ours = rows_10_to_12()
    # the baseline has no wide body of row 13: a stand-in takes its argtypes
    libs["baseline"].int8_matmul_wide_fwd = types.SimpleNamespace()
    cuda_build.load_library = lambda name: libs["baseline"] if name == "adaln_mlp" else load(name)
    am._lib.cache_clear()
    tq._gemm_lib.cache_clear()
    try:
        theirs = rows_10_to_12()
    finally:
        cuda_build.load_library = load
        am._lib.cache_clear()
        tq._gemm_lib.cache_clear()
    same = [torch.equal(u, v) for u, v in zip(ours, theirs)]
    print(f"[adaln-variants] rows 10, 11, 12 through the baseline's adaln_mlp.cu: same bits {same}")
    if not all(same):
        raise RuntimeError("adaln_proj_variants: rows 10-12 gave other bits than the baseline's")


def main() -> None:
    from chip_smoke import COLD_COPIES, QUANT_TOL_BF16, rel_err  # run from the root
    from osu_diffusion_tpu_torch.utils.benchmark import cuda_ms, device_line

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="another checkout of the repository whose int8_matmul.cu "
                        "(the parent's WMMA body) is timed beside these")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("adaln_proj_variants: no CUDA device")
    print(device_line())
    libs, logs = build(variant_sources(opts.baseline), main="int8_matmul.cu", out="adaln_proj_variants")
    for name, log in logs.items():
        lines = sorted({line.strip() for line in log.splitlines() if "registers" in line or "spill" in line})
        print(f"[adaln-variants] {name} ptxas: {'; '.join(lines)}")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        fn = lib.int8_matmul_fwd if name == "baseline" else lib.int8_matmul_skinny_fwd
        fn.restype = i
        # (x, w, s, b, out, rows, k, m, gelu, tiles_per_cta | cw, row_block, stream)
        fn.argtypes = [p] * 5 + [i] * (5 if name == "baseline" else 6) + [p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if opts.baseline is not None:
        check_gemm_rows_unchanged(opts.baseline)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(13)

    def launch(name, plan, x, wq, s, b):
        out = torch.empty((x.shape[0], wq.shape[0]), device=dev)
        rows, k = x.shape
        m = wq.shape[0]
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (x.data_ptr(), wq.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr())
        if name == "baseline":
            err = libs[name].int8_matmul_fwd(*ptrs, rows, k, m, 0, baseline_tiles_per_cta(rows, m, sms), stream)
        else:
            err = libs[name].int8_matmul_skinny_fwd(*ptrs, rows, k, m, 0, plan.cw, plan.row_block,
                                                    stream)
        if err:
            raise RuntimeError(f"adaln_proj_variants: {name} failed to launch: error {err}")
        return out

    for rows, k, m in CASES:
        x = torch.randn((rows, k), generator=g, device=dev)
        wq, s = tq.quantize_weight(torch.randn((m, k), generator=g, device=dev) * k ** -0.5)
        b = torch.randn(m, generator=g, device=dev) * 0.02
        want = tq.int8_matmul_reference(x, wq, s, b, None, torch.bfloat16)
        # label -> (call on a weight, whether it sums in the committed order:
        # the per-warp slabs depend on neither the CTA width nor the x batch)
        committed = tq.adaln_plan(rows, k, m - 1, sms)._replace(m=m)  # the skinny walk at any rows
        fns = {}
        if rows <= tq.SKINNY_ROW_BLOCKS[-1]:
            for cw in tq.SKINNY_WIDTHS:
                plan = committed._replace(cw=cw)
                fns[f"cw{cw}"] = (lambda w, pl=plan: launch("committed", pl, x, w, s, b), True)
            for name in ("xb8", "stagger", "bulk") + DIAGNOSTICS:
                fns[f"{name} cw{committed.cw}"] = (lambda w, n=name: launch(n, committed, x, w, s, b), True)
            for cw in (16, 64):
                plan = committed._replace(cw=cw)
                fns[f"ldg cw{cw}"] = (lambda w, pl=plan: launch("ldg", pl, x, w, s, b), True)
            if rows <= FMA_ROWS:
                fns[f"fma cw{committed.cw}"] = (lambda w: launch("fma", committed, x, w, s, b), False)
        else:
            blocks = f"{committed.row_blocks} row blocks"
            fns[f"skinny cw{committed.cw} ({blocks})"] = (
                lambda w: launch("committed", committed, x, w, s, b), True)
            fns[f"stagger cw{committed.cw} ({blocks})"] = (
                lambda w: launch("stagger", committed, x, w, s, b), True)
        if ROW_BLOCK_ROWS[0] <= rows <= ROW_BLOCK_ROWS[1] and committed.cw == 64:
            for rb in tq.SKINNY_ROW_BLOCKS[1:]:
                plan = committed._replace(row_block=rb)
                fns[f"cw64 rb{rb}"] = (lambda w, pl=plan: launch("committed", pl, x, w, s, b), True)
        if m % 2 == 0:
            wide = tq.AdalnPlan("sm90", rows, k, m, gemm=gemm_plan(rows, m, k, sms, ragged=True))
            fns[f"wide ({wide.gemm.width}-wide tiles, {wide.gemm.grid} CTAs)"] = (
                lambda w: tq._adaln_launch(x, w, s, b, None, wide), False)
        if "baseline" in libs:
            fns["baseline wmma"] = (lambda w: launch("baseline", None, x, w, s, b), False)
        ref = launch("committed", committed, x, wq, s, b)
        bits = {}
        for label, (fn, same_order) in fns.items():
            got = fn(wq)
            torch.cuda.synchronize()
            if label.split()[0] in DIAGNOSTICS:
                bits[label] = False
                continue
            err = rel_err(got, want)
            if err > QUANT_TOL_BF16:
                raise RuntimeError(f"adaln_proj_variants: rows {rows} {label}: {err} > {QUANT_TOL_BF16}")
            bits[label] = torch.equal(got, ref)
            if same_order and not bits[label]:
                raise RuntimeError(f"adaln_proj_variants: rows {rows} {label} gave other bits than "
                                   "the committed body")
        times = {label: [] for label in fns}
        for label in list(fns) + list(fns)[::-1]:
            times[label].append(cuda_ms(lambda: fns[label][0](wq), iters=50))
        print(f"[adaln-variants] rows {rows}, K {k}, M {m}, warm ms in turns: " + "; ".join(
            f"{label} " + ", ".join(f"{t:.4f}" for t in ts) + f" (bits {'=' if bits[label] else '!='})"
            for label, ts in times.items()))
        if rows == 2:  # cold: each call finds its weight copy out of L2
            copies = itertools.cycle([wq.clone() for _ in range(COLD_COPIES)])
            cold = {label: cuda_ms(lambda: fns[label][0](next(copies)), iters=2 * COLD_COPIES)
                    for label in fns}
            print(f"[adaln-variants] rows {rows}, K {k}, M {m}, cold ms ({COLD_COPIES} weight copies): "
                  + "; ".join(f"{label} {t:.4f}" for label, t in cold.items()))


if __name__ == "__main__":
    main()
