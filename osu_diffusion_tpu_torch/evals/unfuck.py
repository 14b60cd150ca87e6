"""Pattern-repair robustness evaluation (port of
osu_diffusion_tpu/evals/unfuck.py).

Behavioral parity with reference testing/unfuck_pattern.py: perturb a span of a
pattern's coordinates with Gaussian noise of a given magnitude, then repeatedly
denoise at t=0 with an in-paint mask pinning everything outside the span, and
report the mean distance to the original before and after repair.

The num_sampling_steps t = 0 steps are the `Sampler`'s refine pass with the
span free and the plain forward (no CFG), all predictions one batch. The
band is `max_seq_len` (the padding to the sampler's 128-row bucket carries
the real length as `valid_len`): at T <= band it covers every key, which is
the reference's full attention, and beyond it is the reference's banded
mask, so every length runs banded attention on the card. At t = 0 a step
adds no noise, so the chain is deterministic given the model.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from osu_diffusion_tpu_torch.beatmap import Beatmap
from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence
from osu_diffusion_tpu_torch.diffusion.process import GaussianDiffusion, NoiseFn
from osu_diffusion_tpu_torch.evals.toy import (
    PLAYFIELD,
    SUITES,
    _toy_root,
    batch_inputs,
    load_filler_seq,
    pad_to_seq_len,
)
from osu_diffusion_tpu_torch.models.dit import DiT
from osu_diffusion_tpu_torch.sampling import Sampler


def example_from_beatmap(
    beatmap: Beatmap, seq_len: int | None, filler_seq: np.ndarray
) -> tuple[np.ndarray, int, int]:
    """(seq (T,19), start, end): the original pattern's row span after optional
    filler padding. Parity: unfuck_pattern.py:32-47."""
    seq = beatmap_to_sequence(beatmap)
    orig_len = seq.shape[0]
    seq = pad_to_seq_len(seq, seq_len, filler_seq)
    # trimmed fixtures fill the whole window: the span start clamps at 0
    return seq, max(0, seq.shape[0] - orig_len), seq.shape[0]


def fuckup_pattern(
    seq: np.ndarray, start: int, end: int, magnitude: float, rng: np.random.Generator
) -> np.ndarray:
    """Add N(0, magnitude) pixel noise to the span's coordinates.
    Parity: unfuck_pattern.py:70-74."""
    out = seq.copy()
    out[start:end, :2] += rng.standard_normal((end - start, 2)).astype(np.float32) * magnitude
    return out


def unfuck_pattern(
    model: DiT,
    diffusion: GaussianDiffusion,
    seq_fucked: np.ndarray,
    start: int,
    end: int,
    num_predictions: int,
    num_sampling_steps: int,
    num_classes: int,
    generator: torch.Generator | None = None,
    noise_fn: NoiseFn | None = None,
    max_seq_len: int = 128,
) -> np.ndarray:
    """Repeated t=0 denoising with the span free and the rest pinned.
    Returns (num_predictions, end-start, 2) repaired pixel coords.
    Parity: unfuck_pattern.py:77-131."""
    device = next(model.parameters()).device
    x, o, c, y = batch_inputs(seq_fucked, num_predictions, num_classes, device)
    free = torch.zeros(x.shape, dtype=torch.bool, device=device)
    free[:, start:end, :] = True
    sampler = Sampler(model, diffusion, band=max_seq_len)
    img = sampler.refine(x, o, c, y, num_sampling_steps, generator, noise_fn,
                         known_mask=free, use_cfg=False)
    return img[:, start:end, :].cpu().numpy() * PLAYFIELD


def evaluate_suite(
    model,
    diffusion,
    suite: str,
    num_predictions: int,
    num_sampling_steps: int,
    num_classes: int,
    seq_len: int | None,
    magnitude: float,
    generator: torch.Generator | None = None,
    assets_dir: str | None = None,
) -> dict:
    """Mean pixel distance before (fucked) and after (unfucked) repair.
    Parity: unfuck_pattern.py:153-182."""
    root = os.path.join(_toy_root(assets_dir), suite)
    filler = load_filler_seq(assets_dir)
    np_rng = np.random.default_rng(0)
    num = 0
    total_before = 0.0
    total_after = 0.0
    for filename in sorted(os.listdir(root)):
        beatmap = Beatmap.from_path(os.path.join(root, filename))
        seq, start, end = example_from_beatmap(beatmap, seq_len, filler)
        if end - start <= 0:
            continue
        seq_fucked = fuckup_pattern(seq, start, end, magnitude, np_rng)
        true_pos = seq[start:end, :2]
        fucked_pos = seq_fucked[start:end, :2]
        preds = unfuck_pattern(
            model, diffusion, seq_fucked, start, end,
            num_predictions, num_sampling_steps, num_classes, generator,
        )
        before = np.linalg.norm(fucked_pos - true_pos, axis=-1)
        after = np.linalg.norm(preds - true_pos[None], axis=-1)
        num += num_predictions * (end - start)
        total_before += float(before.sum()) * num_predictions
        total_after += float(after.sum())
    return {
        "suite": suite,
        "mean_fucked_distance": total_before / max(1, num),
        "mean_unfucked_distance": total_after / max(1, num),
        "num_predictions": num,
    }


def main(argv=None):
    import argparse

    from osu_diffusion_tpu_torch.cli import load_model
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.models.dit import DiT_models

    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--model", type=str, choices=list(DiT_models.keys()),
                        default="DiT-B")
    parser.add_argument("--num-classes", type=int, default=52670)
    parser.add_argument("--num-sampling-steps", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num-predictions", type=int, default=100)
    parser.add_argument("--tests", type=str, nargs="*", default=SUITES)
    parser.add_argument("--seq-len", type=int, default=None)
    parser.add_argument("--noise-schedule", type=str, default="squaredcos_cap_v2")
    parser.add_argument("--fucking-magnitude", type=float, default=5)
    parser.add_argument("--assets-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.set_defaults(quantize_weights=False)  # load_model's flag: the repair runs f32
    args = parser.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    model = load_model(args.ckpt, args, device)
    diffusion = create_diffusion(None, noise_schedule=args.noise_schedule, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    for suite in args.tests:
        print(suite)
        res = evaluate_suite(
            model, diffusion, suite, args.num_predictions,
            args.num_sampling_steps, args.num_classes, args.seq_len,
            args.fucking_magnitude, generator, args.assets_dir,
        )
        print(
            f"Mean fucked distance = {res['mean_fucked_distance']} units "
            f"(out of {res['num_predictions']})"
        )
        print(
            f"Mean unfucked distance = {res['mean_unfucked_distance']} units "
            f"(out of {res['num_predictions']})"
        )


if __name__ == "__main__":
    main()
