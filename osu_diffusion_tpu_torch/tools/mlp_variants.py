"""Time variants of kernel B's Hopper body (the bf16-weight adaLN-MLP
forward) on the card, in turns.

Builds two copies of csrc/adaln_mlp.cu side by side, one nvcc each, into
the package's build directory: the committed body, and one whose up
epilogue stores a and g straight from the accumulator layout (4 bytes a
lane, each warp store touching 8 rows) instead of through the warp's
shared-memory staging tile. With the committed build it also runs other
tile widths than the plan's (`mlp_plan`): 128-wide tiles for both GEMMs,
and 256-wide for both. Times the training forward at the DiT-B training
shape (x (256, 128, 768) bf16) and the inference forward at the sampling
shape (x (2, 768, 768) f32), whole and stage by stage (the modulate pass,
the up GEMM, the down GEMM), in turns from the first variant to the last
and back. The direct-store build must give the committed body's bits;
the other widths' bits are reported (another wgmma width may sum in
another order). Run from the repository root on a card:

    python -m osu_diffusion_tpu_torch.tools.mlp_variants
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import torch

from osu_diffusion_tpu_torch.ops import adaln_mlp as am
from osu_diffusion_tpu_torch.ops import cuda_build

STAGED = """  __syncwarp();  // the warp's reads of the last block are done
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lane / 4 + 8 * i;
      *reinterpret_cast<unsigned*>(st + r * STAGE_ROW + ((n ^ (r & 7)) << 4) + (lane % 4) * 4) =
          vals[n][i];
    }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = it * 4 + lane / 8;
    const int ch = lane % 8;
    const uint4 v = *reinterpret_cast<const uint4*>(st + r * STAGE_ROW + ((ch ^ (r & 7)) << 4));
    if (row0 + r < m) *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * ld + col0 + ch * 8) = v;
  }
"""
DIRECT = """#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lane / 4 + 8 * i;
      if (row0 + r < m)
        *reinterpret_cast<unsigned*>(dst + (long long)(row0 + r) * ld + col0 + 8 * n +
                                     2 * (lane % 4)) = vals[n][i];
    }
"""


def variant_sources() -> dict[str, str]:
    src = open(os.path.join(cuda_build.CSRC_DIR, "adaln_mlp.cu")).read()
    if src.count(STAGED) != 1:
        raise RuntimeError("mlp_variants: the staged store is not in the source once")
    return {"committed": src, "direct_stores": src.replace(STAGED, DIRECT)}


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all at once."""
    out_dir = os.path.join(cuda_build.BUILD_DIR, "mlp_variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC_DIR,
             "-o", os.path.join(out_dir, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
    return libs


def main() -> None:
    from chip_smoke import cuda_ms  # the repository's kernel timer (run from the root)

    if not torch.cuda.is_available():
        raise SystemExit("mlp_variants: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = build(variant_sources())
    load, plan = cuda_build.load_library, am.mlp_plan

    def use(lib, widths):
        """Run kernel B from build `lib`, with the plan's tile widths or `widths` (up, down)."""
        cuda_build.load_library = lambda name: libs[lib] if name == "adaln_mlp" else load(name)
        am._lib.cache_clear()
        am.mlp_plan = plan if widths is None else lambda n, t, d, hdim, sms: tuple(
            p._replace(width=w, grid=min(sms, p._replace(width=w).tiles))
            for p, w in zip(plan(n, t, d, hdim, sms), widths))

    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(7)
    cases = {}
    for name, (n, t, d, dtype, residuals) in {"train": (256, 128, 768, bf16, True),
                                              "sample": (2, 768, 768, torch.float32, False)}.items():
        mod = torch.randn((n, 6 * d), generator=g, device=dev) * 0.3
        args = (torch.randn((n, t, d), generator=g, device=dev).to(dtype),
                mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:],
                (torch.randn((4 * d, d), generator=g, device=dev) * d ** -0.5).to(bf16),
                torch.randn(4 * d, generator=g, device=dev) * 0.02,
                (torch.randn((d, 4 * d), generator=g, device=dev) * (4 * d) ** -0.5).to(bf16),
                torch.randn(d, generator=g, device=dev) * 0.02)
        cases[name] = (args, residuals, d)
    variants = [("committed", None), ("direct_stores", None), ("committed", (128, 128)),
                ("committed", (256, 256))]
    want = {}
    for lib, widths in [*variants, *reversed(variants)]:
        use(lib, widths)
        label = lib if widths is None else f"{lib} at widths up {widths[0]}, down {widths[1]}"
        for name, (args, residuals, d) in cases.items():
            if widths is not None and d % widths[1]:
                continue
            fn = am.adaln_mlp_train if residuals else am.adaln_mlp

            def stage(mask, fn=fn, args=args, residuals=residuals):
                return am._launch(fn, *args, 1e-6, bf16, residuals=residuals, stages=mask)

            got = stage(am.ALL_STAGES)
            torch.cuda.synchronize()
            want.setdefault(name, got)
            same = all(u is None or torch.equal(u, v) for u, v in zip(got, want[name]))
            ms = {k: cuda_ms(lambda m=m: stage(m), iters=50)
                  for k, m in (("whole", am.ALL_STAGES), ("modulate", 1), ("up", 2), ("down", 4))}
            print(f"[mlp-variants] {label}, {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + f" ms; bits equal to the committed body's {same}", flush=True)
            if not same and widths is None:  # another store path must not change a bit
                raise SystemExit(f"mlp_variants: {label} gives other bits at the {name} shape")
    cuda_build.load_library, am.mlp_plan = load, plan
    am._lib.cache_clear()


if __name__ == "__main__":
    main()
