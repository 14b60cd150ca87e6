"""Spacing-fidelity evaluation (port of osu_diffusion_tpu/evals/distances.py):
does a generated map preserve the reference's object spacing? MSE/MAE over
per-datapoint distance deltas. Host-side numpy; no model, no device.

Behavioral parity with reference testing/distance_distance.py:12-40.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from osu_diffusion_tpu_torch.beatmap import Beatmap
from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence


def _distances(seq: np.ndarray) -> np.ndarray:
    """Host-side distance feature (parity data_loading.py:146-151)."""
    xy = seq[:, :2]
    prev = np.concatenate([[[256.0, 192.0]], xy[:-1]], axis=0)
    return np.linalg.norm(xy - prev, axis=1)


def compare_spacing(ref_beatmap: Beatmap, beatmap: Beatmap) -> dict | None:
    ref_d = _distances(beatmap_to_sequence(ref_beatmap))
    d = _distances(beatmap_to_sequence(beatmap))
    if len(d) != len(ref_d):
        return None
    delta = ref_d - d
    return {
        "mse": float(np.mean(np.square(delta))),
        "mae": float(np.mean(np.abs(delta))),
        "delta": delta,
    }


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--ref-beatmap", type=str, required=True)
    parser.add_argument("--beatmap", type=str, required=True,
                        help="a .osu file or a directory of them")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--plot", action="store_true")
    args = parser.parse_args(argv)

    ref = Beatmap.from_path(args.ref_beatmap)
    paths = (
        sorted(glob.glob(os.path.join(args.beatmap, "*.osu")))
        if os.path.isdir(args.beatmap)
        else [args.beatmap]
    )
    for path in paths:
        bm = Beatmap.from_path(path)
        name = args.name or bm.version
        res = compare_spacing(ref, bm)
        if res is None:
            print(f"{name}: sequence length mismatch, skipped")
            continue
        print(f"{name}: MSE = {res['mse']}, MAE = {res['mae']}")
        if args.plot:
            import matplotlib.pyplot as plt

            bin_edges = np.linspace(-20, 20, 42)
            plt.hist(res["delta"], bins=bin_edges, alpha=0.75, color="b",
                     edgecolor="k")
            plt.xlabel("Distance")
            plt.ylabel("Frequency")
            plt.title(f"Distance similarity gen. beatmap [{name}]")
            plt.grid(True)
            plt.show()


if __name__ == "__main__":
    main()
