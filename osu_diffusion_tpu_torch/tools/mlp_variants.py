"""Time variants of kernel B's Hopper body (the bf16-weight adaLN-MLP
forward) on the card, in turns.

Builds copies of csrc/adaln_mlp.cu side by side, one nvcc each, into the
package's build directory: the committed body, and one whose up epilogue
stores a and g straight from the accumulator layout (4 bytes a lane, each
warp store touching 8 rows) instead of through the warp's shared-memory
staging tile (csrc/gemm_sm90.cuh, stage_store); with `--baseline DIR`,
also the forward of another checkout of the repository at DIR, which
must give the committed body's bits. With the committed build it also runs other
tile widths than the plan's (`mlp_plan`): 128-wide tiles for both GEMMs,
and 256-wide for both. Times the training forward at the DiT-B training
shape (x (256, 128, 768) bf16) and the inference forward at the sampling
shape (x (2, 768, 768) f32), whole and stage by stage (the modulate pass,
the up GEMM, the down GEMM), in turns from the first variant to the last
and back. The direct-store build must give the committed body's bits;
the other widths' bits are reported (another wgmma width may sum in
another order). Run from the repository root on a card:

    python -m osu_diffusion_tpu_torch.tools.mlp_variants [--baseline DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import os
import subprocess

import torch

from osu_diffusion_tpu_torch.ops import adaln_mlp as am
from osu_diffusion_tpu_torch.ops import cuda_build

STAGED = """  __syncwarp();  // the warp's reads of the last block are done
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) *stage_slot(st, n, i, lane) = vals[n][i];
  stage_flush(st, dst, row0, col0, m, ld, lane);
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


def variant_sources(baseline: str | None) -> dict[str, dict[str, str]]:
    """Each variant's files (name -> text) beside its adaln_mlp.cu: a file
    given here takes the place of the committed csrc/ file of that name."""
    def read(path):
        with open(path) as f:
            return f.read()

    src = read(os.path.join(cuda_build.CSRC_DIR, "adaln_mlp.cu"))
    header = read(os.path.join(cuda_build.CSRC_DIR, "gemm_sm90.cuh"))
    if header.count(STAGED) != 1:
        raise RuntimeError("mlp_variants: the staged store is not in gemm_sm90.cuh once")
    variants = {"committed": {"adaln_mlp.cu": src},
                "direct_stores": {"adaln_mlp.cu": src, "gemm_sm90.cuh": header.replace(STAGED, DIRECT)}}
    if baseline is not None:
        csrc = os.path.join(baseline, "osu_diffusion_tpu_torch", "csrc")
        variants["baseline"] = {os.path.basename(p): read(p)
                                for p in glob.glob(os.path.join(csrc, "*.cu*"))}
    return variants


def build(sources: dict[str, dict[str, str]], main: str = "adaln_mlp.cu",
          out: str = "mlp_variants") -> tuple[dict[str, ctypes.CDLL], dict[str, str]]:
    """One nvcc per variant of the source `main`, all at once, each in its
    own directory under the build directory's `out` (a quoted include finds
    the variant's own files first). Returns the libraries and nvcc's logs
    (with ptxas's registers and spills)."""
    out_dir = os.path.join(cuda_build.BUILD_DIR, out)
    procs = {}
    for name, files in sources.items():
        os.makedirs(os.path.join(out_dir, name), exist_ok=True)
        for file, text in files.items():
            with open(os.path.join(out_dir, name, file), "w") as f:
                f.write(text)
        path = os.path.join(out_dir, name, main)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC_DIR,
             "-o", os.path.join(out_dir, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, logs = {}, {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{logs[name]}")
        libs[name] = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
    return libs, logs


def main() -> None:
    from osu_diffusion_tpu_torch.utils.benchmark import cuda_ms, device_line

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="another checkout of the repository, whose kernel B "
                        "forward must give the committed body's bits")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mlp_variants: no CUDA device")
    print(device_line())
    libs, _ = build(variant_sources(opts.baseline))
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
    if opts.baseline is not None:
        variants.insert(1, ("baseline", None))
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
