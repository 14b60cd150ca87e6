"""Style-transfer separation measurement (port of tools/style_separation.py).

The reference's product loop conditions sampling on a per-beatmap "style"
label through the learned embedding table with CFG (reference
sample.py:87-108, README.md:17). This tool quantifies, at the OUTPUT level,
that different --style-id values actually change the generated coordinates:
given the .osu files produced by `sample_torch.py --style-id K` for several K over
the SAME input skeleton and seed, it reports

- within-style spread: mean per-object distance between variants of the
  same style (the CFG-noise floor), and
- cross-style distance: mean per-object distance between outputs of
  different styles,

plus the separation ratio cross/within. Ratio >> 1 = the style conditioning
measurably steers the output beyond sampling noise.

Usage:
  python -m osu_diffusion_tpu_torch.tools.style_separation --pattern 'results/*/*.osu'
The style id is parsed from the generated filename suffix
("... result <style_id> <idx>*.osu", cli.py sample_main naming). Host-side
numpy over the port's beatmap parser and featurizer; no model, no device.
"""
from __future__ import annotations

import argparse
import glob
import itertools
import json
import os
import re

import numpy as np

from osu_diffusion_tpu_torch.beatmap import Beatmap
from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence


def coords_of(path: str) -> np.ndarray:
    return np.asarray(beatmap_to_sequence(Beatmap.from_path(path)))[:, :2]


def mean_obj_distance(a: np.ndarray, b: np.ndarray) -> float:
    n = min(len(a), len(b))
    return float(np.mean(np.linalg.norm(a[:n] - b[:n], axis=1)))


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--pattern", type=str, required=True,
                   help="glob of generated .osu files")
    p.add_argument("--style-regex", type=str,
                   default=r"result (-?\d+) ",
                   help="regex whose group 1 is the style id in the filename")
    args = p.parse_args(argv)

    by_style: dict[str, list[np.ndarray]] = {}
    for path in sorted(glob.glob(args.pattern)):
        m = re.search(args.style_regex, os.path.basename(path))
        if not m:
            continue
        by_style.setdefault(m.group(1), []).append(coords_of(path))
    if len(by_style) < 2:
        raise SystemExit(f"need >= 2 styles, found {sorted(by_style)}")

    within = [
        mean_obj_distance(a, b)
        for outs in by_style.values()
        for a, b in itertools.combinations(outs, 2)
    ]
    cross = [
        mean_obj_distance(a, b)
        for (sa, outs_a), (sb, outs_b) in itertools.combinations(
            sorted(by_style.items()), 2
        )
        for a in outs_a
        for b in outs_b
    ]
    w = float(np.mean(within)) if within else float("nan")
    c = float(np.mean(cross))
    print(json.dumps({
        "styles": sorted(by_style),
        "outputs_per_style": {k: len(v) for k, v in sorted(by_style.items())},
        "within_style_px": round(w, 2),
        "cross_style_px": round(c, 2),
        "separation_ratio": round(c / w, 3) if within and w > 0 else None,
    }))


if __name__ == "__main__":
    main()
