"""Toy-suite in-paint evaluation (port of osu_diffusion_tpu/evals/toy.py).

Behavioral parity with reference testing/test_toy.py: for each hand-authored
pattern, in-paint the final object's position (all other coordinates pinned via
denoised_fn each step) with the null class and count predictions within 30 px.

All predictions of an example are one batch through the port's `Sampler`
(the plain forward, no CFG), so on the card every block runs banded
attention and the fused adaLN-MLP (or the int8 kernels under
--quantize-weights) at batch `num_predictions`. Draws come from an explicit
`torch.Generator`, or from `z` and `noise_fn` (a test replays JAX's).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from osu_diffusion_tpu_torch.beatmap import Beatmap
from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence
from osu_diffusion_tpu_torch.data.process import split_and_process_sequence_no_augment
from osu_diffusion_tpu_torch.diffusion.process import NoiseFn
from osu_diffusion_tpu_torch.sampling import Sampler

PLAYFIELD = np.array([512.0, 384.0], dtype=np.float32)
SUITES = ["geometry", "stream", "symmetry", "visual_spacing"]
GOOD_RADIUS_PX = 30.0  # parity: test_toy.py:163-164


def _toy_root(assets_dir: str | None = None) -> str:
    if assets_dir is not None:
        return assets_dir
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "assets", "toy_datasets")


def load_filler_seq(assets_dir: str | None = None) -> np.ndarray:
    """kimi_no_bouken context filler (parity: test_toy.py:21)."""
    path = os.path.join(_toy_root(assets_dir), "kimi_no_bouken.osu")
    return beatmap_to_sequence(Beatmap.from_path(path))


def pad_to_seq_len(seq: np.ndarray, seq_len: int | None, filler_seq: np.ndarray) -> np.ndarray:
    """The length pinned to seq_len: filler rows in front (the pattern's
    times re-based 300 ms after the filler's last), or the last seq_len
    rows. Parity: test_toy.py:100-112, unfuck_pattern.py:36-45."""
    if seq_len is not None:
        if seq_len > seq.shape[0]:
            to_add = seq_len - seq.shape[0]
            filler_add = filler_seq[-to_add:].copy()
            seq = seq.copy()
            seq[:, 2] += filler_add[-1, 2] - seq[0, 2] + 300
            seq = np.concatenate([filler_add, seq], axis=0)
        elif seq_len < seq.shape[0]:
            seq = seq[-seq_len:]
    return seq


def example_from_beatmap(
    beatmap: Beatmap, seq_len: int | None, filler_seq: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """(seq (T,19), label (2,)) with trailing slider-body steps trimmed and the
    length pinned to seq_len using filler context. Parity: test_toy.py:79-112."""
    seq = beatmap_to_sequence(beatmap)
    hit_objects = beatmap.hit_objects(spinners=False)
    posterior = hit_objects[-1]
    label = np.array([posterior.position.x, posterior.position.y], dtype=np.float32)

    # trim trailing slider-body datapoints (types > 5)
    type_index = np.argmax(seq[:, 3:], axis=1)
    bad = type_index > 5
    num_bad = 0
    for flag in bad[::-1]:
        if flag:
            num_bad += 1
        else:
            break
    if num_bad > 0:
        seq = seq[:-num_bad]

    assert np.allclose(seq[-1, :2], label), "trim did not land on the target object"
    return pad_to_seq_len(seq, seq_len, filler_seq), label


def load_example_folder(
    name: str, seq_len: int | None, assets_dir: str | None = None
) -> list[tuple[np.ndarray, np.ndarray]]:
    root = os.path.join(_toy_root(assets_dir), name)
    filler = load_filler_seq(assets_dir)
    data = []
    for filename in sorted(os.listdir(root)):
        beatmap = Beatmap.from_path(os.path.join(root, filename))
        data.append(example_from_beatmap(beatmap, seq_len, filler))
    return data


def batch_inputs(seq_no_embed: np.ndarray, n: int, num_classes: int, device):
    """One processed sequence as n rows (x, o, c) of the null class y, each
    contiguous (the kernels refuse a broadcast's zero strides), o relative
    to the first point. Returns (x, o, c, y)."""
    seq = torch.from_numpy(np.ascontiguousarray(seq_no_embed, dtype=np.float32)).to(device)
    (seq_x, seq_o, seq_c), seq_len = split_and_process_sequence_no_augment(seq)
    seq_o = seq_o - seq_o[0]
    x = seq_x[None].expand(n, seq_len, 2).contiguous()
    o = seq_o[None].expand(n, seq_len).contiguous()
    c = seq_c[None].expand(n, seq_len, seq_c.shape[-1]).contiguous()
    y = torch.full((n,), num_classes, dtype=torch.long, device=device)
    return x, o, c, y


def generate_predictions(
    sampler: Sampler,
    seq_no_embed: np.ndarray,
    num_predictions: int,
    num_classes: int,
    generator: torch.Generator | None = None,
    noise_fn: NoiseFn | None = None,
    z: torch.Tensor | None = None,
) -> np.ndarray:
    """In-paint the last datapoint's position num_predictions times.
    Returns (num_predictions, 2) pixel coordinates. Parity: test_toy.py:32-76.

    The initial noise is `z` (N, T, 2) when given, else drawn from
    `generator` on the model's device; the chain's per-step noise comes
    from `noise_fn` when given, else from `generator`."""
    device = next(sampler.model.parameters()).device
    n = num_predictions
    x, o, c, y = batch_inputs(seq_no_embed, n, num_classes, device)
    mask = torch.zeros(x.shape, dtype=torch.bool, device=device)
    mask[:, -1, :] = True  # True = free: only the last datapoint is sampled
    if z is None:
        z = torch.randn(x.shape, generator=generator, device=device, dtype=torch.float32)
    z = torch.where(mask, z.to(device), x)
    samples = sampler(z, o, c, y, generator=generator, noise_fn=noise_fn,
                      known_x=x, known_mask=mask, use_cfg=False)
    return samples[:, -1, :].cpu().numpy() * PLAYFIELD


def evaluate_suite(
    sampler: Sampler,
    suite: str,
    num_predictions: int,
    num_classes: int,
    seq_len: int | None,
    generator: torch.Generator | None = None,
    assets_dir: str | None = None,
) -> dict:
    """Fraction of in-painted predictions within 30 px of the truth (the
    fixtures in file order, each drawing from `generator` in turn)."""
    examples = load_example_folder(suite, seq_len, assets_dir)
    num_total = 0
    num_good = 0
    for seq, label in examples:
        preds = generate_predictions(sampler, seq, num_predictions, num_classes, generator)
        distances = np.linalg.norm(preds - label, axis=1)
        num_good += int((distances < GOOD_RADIUS_PX).sum())
        num_total += len(preds)
    return {
        "suite": suite,
        "accuracy": num_good / max(1, num_total),
        "good": num_good,
        "total": num_total,
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
    parser.add_argument("--generate", type=str, default=None,
                        help="single fixture (relative to the toy root): print "
                             "per-prediction coordinates (parity test_toy.py:154-167)")
    parser.add_argument("--seq-len", type=int, default=None)
    parser.add_argument("--noise-schedule", type=str, default="squaredcos_cap_v2")
    parser.add_argument("--assets-dir", type=str, default=None)
    parser.add_argument("--accel-interval", type=int, default=1,
                        help="Δ-cache accelerated sampling (see Sampler): "
                             "full model every Nth step, cached middle-block "
                             "residual in between; 1 = exact")
    parser.add_argument("--accel-span", type=int, nargs=2, default=None,
                        metavar=("LO", "HI"))
    parser.add_argument("--accel-tau", type=float, default=None,
                        help="adaptive Δ-cache (see Sampler): error-driven "
                             "skips below this relative input drift")
    parser.add_argument("--accel-max-skip", type=int, default=7)
    parser.add_argument("--quantize-weights", action="store_true",
                        help="int8 weight-only serving, quantized at load as the "
                             "sample CLI does: measures the accuracy cost of the "
                             "quantized chain on a trained checkpoint")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    # the plain f32 parts in full f32 on the card, as the sample CLI runs them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    model = load_model(args.ckpt, args, device)
    diffusion = create_diffusion(
        str(args.num_sampling_steps), noise_schedule=args.noise_schedule, device=device
    )
    # band follows --seq-len (the trained window), not a hardcoded 128: the
    # reference masks beyond +-seq_len neighbours whenever the example length
    # exceeds the window (test_toy.py:37-42). At T <= band this equals full
    # attention, so the default matches the reference's seq_len-128 protocol.
    sampler = Sampler(
        model, diffusion, band=args.seq_len or 128,
        accel_interval=args.accel_interval,
        accel_span=tuple(args.accel_span) if args.accel_span else None,
        accel_tau=args.accel_tau,
        accel_max_skip=args.accel_max_skip,
    )
    generator = torch.Generator(device=device).manual_seed(args.seed)

    if args.generate is not None:
        path = os.path.join(_toy_root(args.assets_dir), args.generate)
        beatmap = Beatmap.from_path(path)
        end_time = beatmap.hit_objects()[-1].time.total_seconds() * 1000
        filler = load_filler_seq(args.assets_dir)
        seq, pos = example_from_beatmap(beatmap, args.seq_len, filler)
        preds = generate_predictions(
            sampler, seq, args.num_predictions, args.num_classes, generator
        )
        distances = np.linalg.norm(preds - pos, axis=1)
        good = int((distances < GOOD_RADIUS_PX).sum())
        print(
            f"Generate example correct predictions = "
            f"{good / len(preds) * 100}% ({good}/{len(preds)})"
        )
        for p_ in preds:
            print(f"{round(float(p_[0]))},{round(float(p_[1]))},{round(end_time)},1,0,0:0:0:0:")
        return

    for suite in args.tests:
        print(suite)
        res = evaluate_suite(
            sampler, suite, args.num_predictions, args.num_classes,
            args.seq_len, generator, args.assets_dir,
        )
        print(
            f"Correct predictions = {res['accuracy'] * 100}% "
            f"({res['good']}/{res['total']})"
        )
        if sampler.accel and sampler.last_full_model_steps is not None:
            # adaptive/fixed Δ-cache: how much of the chain actually ran the
            # full model (the quality table pairs this with the accuracy)
            print(
                f"full model steps = {int(sampler.last_full_model_steps)}"
                f"/{args.num_sampling_steps}"
            )


if __name__ == "__main__":
    main()
