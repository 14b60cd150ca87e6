"""Time variants of the fused MLP backward's Hopper body (rows 9a/9b, bf16
stream) on the card, in turns.

Builds copies of csrc/adaln_mlp_bwd.cu side by side, one nvcc each, into the
package's build directory, which differ only in when the dgelu GEMM's
epilogue fetches each 64-column block of `a` into registers: the committed
body fetches a tile's first block while the tile's products run and the
next one halfway through a block's math; "at_epilogue" fetches the first
block when the epilogue begins; "no_prefetch" fetches every block at its
start. With `--baseline DIR`, also the backward of another checkout of the
repository at DIR (the same C interface). Prints each build's dgelu GEMM
registers and spill bytes (ptxas), then times the body's four kernels
alone (the dmlp pass and the dgelu GEMM, each with its sums of partials;
the dh1 GEMM; the row pass with its sums) at the DiT-B training shape (x
(256, 128, 768) bf16, H 3072) at the tile plan's widths (`mlp_bwd_plan`),
from the first variant to the last and back. Every variant must give the
committed body's bits; the baseline's are reported (another order of the
partial sums gives other bits). Run from the repository root on a card:

    python -m osu_diffusion_tpu_torch.tools.mlp_bwd_variants [--baseline DIR]
"""
from __future__ import annotations

import argparse
import glob
import os
import re

import torch

from osu_diffusion_tpu_torch.ops import adaln_mlp as am
from osu_diffusion_tpu_torch.ops import cuda_build
from osu_diffusion_tpu_torch.tools.mlp_variants import build

BEGIN = """      a_blk.fetch(ep.a, r0 + (threadIdx.x / 32) * 16, c0, m, ncols, lane);
"""
HALFWAY = """          if (nn == 4 && cb + 1 < BN / 64)
            a_blk.fetch(ep.a, row0, c0 + (cb + 1) * 64, m, ncols, lane);
"""
LOAD = """        a_blk.load(st, av, lane);
"""


def variant_sources(baseline: str | None) -> dict[str, dict[str, str]]:
    with open(os.path.join(cuda_build.CSRC_DIR, "adaln_mlp_bwd.cu")) as f:
        src = f.read()
    for text in (BEGIN, HALFWAY, LOAD):
        if src.count(text) != 1:
            raise RuntimeError(f"mlp_bwd_variants: not in the source once:\n{text}")
    no_begin = src.replace(BEGIN, "      ;\n")
    at_epilogue = no_begin.replace(
        LOAD, "        if (cb == 0) a_blk.fetch(ep.a, row0, c0, m, ncols, lane);\n" + LOAD)
    no_prefetch = no_begin.replace(HALFWAY, "").replace(
        LOAD, "        a_blk.fetch(ep.a, row0, c0 + cb * 64, m, ncols, lane);\n" + LOAD)
    variants = {name: {"adaln_mlp_bwd.cu": text} for name, text in
                (("committed", src), ("at_epilogue", at_epilogue), ("no_prefetch", no_prefetch))}
    if baseline is not None:
        csrc = os.path.join(baseline, "osu_diffusion_tpu_torch", "csrc")
        variants["baseline"] = {}
        for path in glob.glob(os.path.join(csrc, "*.cu*")):
            with open(path) as f:
                variants["baseline"][os.path.basename(path)] = f.read()
    return variants


def dgelu_resources(log: str) -> dict[int, str]:
    """{tile width: 'R registers, S spill bytes'} of a build's dgelu GEMMs."""
    found, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        k = entry and re.search(r"adaln_mlp_bwd_gemm_kernelILi(\d+)ELi0E", entry)
        if not k:
            continue
        if (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            found[int(k[1])] = f"{int(m[1]) + int(m[2])} spill bytes"
        if (m := re.search(r"Used (\d+) registers", line)):
            found[int(k[1])] = f"{m[1]} registers, " + found.get(int(k[1]), "")
    return found


def main() -> None:
    from osu_diffusion_tpu_torch.utils.benchmark import cuda_ms, device_line

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", help="another checkout of the repository, whose fused "
                        "backward is timed beside these")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mlp_bwd_variants: no CUDA device")
    print(device_line())
    libs, logs = build(variant_sources(opts.baseline), main="adaln_mlp_bwd.cu", out="mlp_bwd_variants")
    for name, log in logs.items():
        print(f"[mlp-bwd-variants] {name}: dgelu GEMM (ptxas) "
              + "; ".join(f"{w}-wide {r}" for w, r in sorted(dgelu_resources(log).items())), flush=True)
    load = cuda_build.load_library

    def use(lib):
        """The backward from build `lib`."""
        cuda_build.load_library = lambda name: libs[lib] if name == "adaln_mlp_bwd" else load(name)
        am._bwd_lib.cache_clear()

    dev, bf16 = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(8)
    n, t, d = 256, 128, 768
    hdim = 4 * d

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=dev) * std

    mod = rnd(n, 6 * d, std=0.3)
    shift, scale, gate = mod[:, 3 * d:4 * d], mod[:, 4 * d:5 * d], mod[:, 5 * d:]
    x, gout, a = rnd(n, t, d).to(bf16), rnd(n, t, d).to(bf16), rnd(n, t, hdim).to(bf16)
    mlp = rnd(n, t, d)
    fc1_w = rnd(hdim, d, std=d ** -0.5).to(bf16)
    fc2_w = rnd(d, hdim, std=hdim ** -0.5).to(bf16)
    da = rnd(n, t, hdim, std=0.02).to(bf16)
    want = None
    for lib in [*libs, *reversed(list(libs))]:
        use(lib)
        pro = am._bwd_prologue_launch(gout, mlp, a, gate, fc2_w, bf16)
        epi = am._bwd_epilogue_launch(da, x, gout, shift, scale, fc1_w, 1e-6, bf16)
        torch.cuda.synchronize()
        want = want or (*pro, *epi)
        same = all(torch.equal(u, v) for u, v in zip((*pro, *epi), want))
        ms = {name: cuda_ms(lambda fn=fn, mask=mask: fn(mask), iters=50) for name, fn, mask in (
            ("dmlp pass", lambda m: am._bwd_prologue_launch(gout, mlp, a, gate, fc2_w, bf16, m), 1),
            ("dgelu GEMM", lambda m: am._bwd_prologue_launch(gout, mlp, a, gate, fc2_w, bf16, m), 2),
            ("dh1 GEMM", lambda m: am._bwd_epilogue_launch(da, x, gout, shift, scale, fc1_w, 1e-6,
                                                           bf16, m), 1),
            ("row pass", lambda m: am._bwd_epilogue_launch(da, x, gout, shift, scale, fc1_w, 1e-6,
                                                           bf16, m), 2))}
        print(f"[mlp-bwd-variants] {lib}: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f" ms; bits equal to the committed body's {same}", flush=True)
        if not same and lib != "baseline":  # when `a` is fetched must not change a bit
            raise SystemExit(f"mlp_bwd_variants: {lib} gives other bits")
    cuda_build.load_library = load
    am._bwd_lib.cache_clear()


if __name__ == "__main__":
    main()
