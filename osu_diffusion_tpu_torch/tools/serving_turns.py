"""Time the sample CLI's main chains, f32 and --quantize-weights, of two or
more source trees of this repository in one process on one card, in turns.

The trees' packages are imported one after another into this process. For
each tree: its package is imported from the tree's root, its sample CLI
runs once a mode (DiT-B weights from a seed, kimi, 50 steps, CFG 2, band
128), and the Sampler is kept with its inputs; then the package's modules
are dropped from `sys.modules`, so the next tree imports its own. The kept
objects go on using the modules they were made with, and each tree loads
the kernel libraries it built. So every chain runs on the same host
thread of the same process, and the trees differ only in their code.

After a warm-up chain of each, chains are timed tree by tree, the order
reversed each round (first, second, second, first, ...): CUDA events
around the call (s per denoise step) and the host's clock until the call
returns (the enqueue time; the chain never waits for the card). Prints
each tree's times, their medians and the difference from the first tree,
and the median and quartiles of the ratio of each round's time to the
first tree's in the same round (the host's speed drifts over a call, a
round's trees see nearly the same host). Naming one tree twice gives the
noise floor of the comparison. Run from a tree's root on a card:

    python -m osu_diffusion_tpu_torch.tools.serving_turns --trees OLD NEW NEW [--rounds 30]
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

MODES = ("f32", "int8")
PACKAGE = "osu_diffusion_tpu_torch"
BEATMAP = os.path.join("assets", "toy_datasets", "kimi_no_bouken.osu")
MODEL, NUM_CLASSES, STEPS, CFG_SCALE, BAND, SEED = "DiT-B", 52670, 50, 2.0, 128, 0


def random_state_dict(model, generator):
    """Seeded weights, none zero (adaLN-Zero's zero adaLN and final layer
    would gate the blocks out), as chip_smoke.py makes them."""
    sd = {}
    for name, p in model.state_dict().items():
        if name.endswith("playfield_size"):
            sd[name] = p.clone()
        elif "adaLN" in name or "final_layer.linear" in name or p.ndim == 1:
            sd[name] = torch.randn(p.shape, generator=generator) * 0.02
        elif "embedding_table" in name:
            sd[name] = torch.randn(p.shape, generator=generator)
        else:
            sd[name] = torch.randn(p.shape, generator=generator) * p.shape[1] ** -0.5
    return sd


def drop_package() -> None:
    """Forget every imported module of the package, so the next import
    reads another tree's."""
    for name in [m for m in sys.modules if m == PACKAGE or m.startswith(PACKAGE + ".")]:
        del sys.modules[name]


def tree_samplers(tree: str, tmp: str) -> dict:
    """{mode: (sampler, call args)} of the sample CLI of `tree`'s package,
    run from the tree's root; the package's modules are dropped after."""
    tree = os.path.abspath(tree)
    drop_package()
    sys.path.insert(0, tree)
    cwd = os.getcwd()
    os.chdir(tree)
    try:
        sampling = importlib.import_module(PACKAGE + ".sampling")
        cli = importlib.import_module(PACKAGE + ".cli")
        dit = importlib.import_module(PACKAGE + ".models.dit")
        ckpt = os.path.join(tmp, "dit_b_random.pt")
        if not os.path.exists(ckpt):
            model = dit.DiT_models[MODEL](num_classes=NUM_CLASSES)
            torch.save({"ema": random_state_dict(model, torch.Generator().manual_seed(SEED))}, ckpt)
            del model
        argv = ["--beatmap", BEATMAP, "--ckpt", ckpt, "--model", MODEL, "--num-classes",
                str(NUM_CLASSES), "--num-sampling-steps", str(STEPS), "--cfg-scale", str(CFG_SCALE),
                "--seq-len", str(BAND), "--seed", str(SEED), "--device", "cuda"]
        captured = []
        orig_call = sampling.Sampler.__call__

        def capture(self, *args, **kwargs):
            captured.append((self, args))
            return orig_call(self, *args, **kwargs)

        sampling.Sampler.__call__ = capture
        samplers = {}
        try:
            for mode in MODES:
                results = os.path.join(tmp, f"results-{len(os.listdir(tmp))}")
                cli.sample_main(cli.build_sample_parser().parse_args(
                    argv + ["--results-dir", results] + ["--quantize-weights"] * (mode == "int8")))
                samplers[mode] = captured[-1]
        finally:
            sampling.Sampler.__call__ = orig_call
        print(f"[serving-turns] {tree}: the package of {os.path.dirname(sampling.__file__)}", flush=True)
        return samplers
    finally:
        os.chdir(cwd)
        sys.path.remove(tree)
        drop_package()


def chain(sampler, args) -> dict:
    """One chain: s per denoise step by CUDA events, and the host's."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    host = time.perf_counter()
    sampler(*args, generator=torch.Generator(device="cuda").manual_seed(SEED))
    host = time.perf_counter() - host
    end.record()
    torch.cuda.synchronize()
    return {"s_per_step": start.elapsed_time(end) / 1000 / STEPS, "host_s_per_step": host / STEPS}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--trees", nargs="+", required=True,
                        help="source tree roots, the first the reference; a tree named twice "
                             "gives the noise floor")
    parser.add_argument("--rounds", type=int, default=30)
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs the chains
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    labels = [f"{i}:{tree}" for i, tree in enumerate(args.trees)]
    with tempfile.TemporaryDirectory() as tmp:
        samplers = {label: tree_samplers(tree, tmp) for label, tree in zip(labels, args.trees)}
    for label in labels:
        for mode in MODES:
            chain(*samplers[label][mode])  # warm-up
    times = {(mode, label): [] for mode in MODES for label in labels}
    for r in range(args.rounds):
        for mode in MODES:
            for label in labels[::-1] if r % 2 else labels:
                times[mode, label].append(chain(*samplers[label][mode]))
    print(f"[serving-turns] {card}: DiT-B on kimi (T 757 -> 768), CFG batch 2, {STEPS} steps, "
          f"band {BAND}; one process, {args.rounds} rounds, the order of the trees reversed each round")
    summary = {}
    for mode in MODES:
        base = None
        for label in labels:
            runs = times[mode, label]
            wall = statistics.median(t["s_per_step"] for t in runs)
            host = statistics.median(t["host_s_per_step"] for t in runs)
            base = wall if base is None else base
            ratios = [t["s_per_step"] / t0["s_per_step"] for t, t0 in zip(runs, times[mode, labels[0]])]
            q1, q2, q3 = statistics.quantiles(ratios, n=4)
            summary[f"{mode} {label}"] = {"s_per_step": wall, "host_s_per_step": host,
                                          "round_ratio_quartiles": [q1, q2, q3]}
            print(f"[serving-turns] {mode} {label}: s per denoise step "
                  + ", ".join(f"{t['s_per_step']:.6f}" for t in runs)
                  + f"; median {wall:.6f} ({100 * (wall / base - 1):+.1f}% against {labels[0]}), "
                  f"host enqueue median {host:.6f}; each round against {labels[0]}'s: median "
                  f"{q2:.4f}x, quartiles {q1:.4f}x and {q3:.4f}x")
    print(json.dumps({"serving_turns": summary, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
