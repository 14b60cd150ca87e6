"""Sample and train command lines (port of osu_diffusion_tpu/cli.py).

sample: reads a beatmap, featurizes its rhythm skeleton, samples new
coordinates with a DiT checkpoint through classifier-free guidance, and
writes each result as a .osu file. On a CUDA device every DiT block runs the
inference kernels (banded attention with band = --seq-len, and the fused
adaLN-MLP). With --quantize-weights the f32 checkpoint is quantized to int8
weight-only blocks at load (models/quantize.py) and every block runs the
int8 kernels around the banded attention core instead. The JAX CLI's
sampling flags: --sampling-method ddim, --compute-dtype bf16 (a bf16
residual stream; refused with --quantize-weights), the Δ-cache
(--accel-interval, --accel-span, --accel-tau, --accel-max-skip),
--augment-flip, the refine pass (--refine-ckpt, --refine-iters: a second
.osu per variant), and --plot-time/--plot-width/--make-animation (which
import matplotlib when asked; nothing else needs it). --use-amp is accepted
and changes nothing. The JAX CLI's --use-pallas and --scan-blocks have no
counterpart. `serving_regime_warnings` is the JAX CLI's guardrail with the
regime boundaries measured on the H100 (on that card neither fast flag
has a losing regime, so it warns on nothing).

train: trains a DiT on a Track dataset (train/trainer.py). On a CUDA device
every block runs the training kernels (with --mlp-bwd fused also the MLP
half's two backward kernels). --embed-only-epochs and --relearn-embeds are
the reference's fine-tuning flow; train_nodist_torch.py is the refine-model
trainer (timestep 0 only). Under torchrun (one process per device) the
ranks train data-parallel; --num-model N --context-parallel splits each
window's sequence over N of them (ranged attention kernels behind a halo
exchange), --band narrows the attention for long windows, and --dist picks
the backend (nccl on CUDA, gloo on the CPU by default; gloo also runs
several ranks on one card). --num-model N shards the MLPs, the adaLN heads
and the label table over the N model ranks at every degree the JAX rules
take (a part N does not divide stays whole), without --context-parallel
(tensor parallelism) and with it (each block gathers its shards whole).
Every --model trains on every path, DiT-XL included (--mlp-bwd fused and
--context-parallel too). --steps-per-call k runs k optimizer steps a call
(the JAX trainer's flag): one CUDA graph of the k steps on a card in one
process, eager under a process group and on the CPU; its default is 1, not
JAX's 8 (train/trainer.py says why). The JAX trainer's TPU-only knobs
(--use-pallas, --pallas-ops, --flash-block, --scan-blocks, --multihost)
have no counterpart here.
"""
from __future__ import annotations

import argparse
import logging
import os
import re
from datetime import datetime

import numpy as np
import torch

from osu_diffusion_tpu_torch.beatmap import Beatmap
from osu_diffusion_tpu_torch.export import create_beatmap, plot_beatmap
from osu_diffusion_tpu_torch import CONTEXT_SIZE
from osu_diffusion_tpu_torch.data.dataset import get_beatmap_idx
from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence
from osu_diffusion_tpu_torch.data.process import (
    split_and_process_sequence,
    split_and_process_sequence_no_augment,
)
from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
from osu_diffusion_tpu_torch.models.dit import DiT_models
from osu_diffusion_tpu_torch.models.quantize import restore_quantized
from osu_diffusion_tpu_torch.sampling import Sampler, prepare_cfg_inputs
from osu_diffusion_tpu_torch.train.checkpoint import load_checkpoint
from osu_diffusion_tpu_torch.train.trainer import TrainConfig, train

CLEAN_FILENAME_RX = re.compile(r"[/\\?%*:|\"<>\x7F\x00-\x1F]")


def serving_regime_warnings(quantize_weights: bool, accel_interval: int, t_len: int,
                            dispatch_batch: int) -> list[str]:
    """Warnings for a fast serving flag asked for where it measured slower
    than the chain it replaces: the JAX CLI's guardrail, same signature and
    return (each warning also sent through warnings.warn(RuntimeWarning)).

    The boundaries are the H100's, not the TPU's: two sweeps of
    osu_diffusion_tpu_torch/tools/bench_quant.py over the graphed chains
    (DiT-B, seeded reference init, 100-step exact f32 chains, band 128,
    `--groups 5 --runs 5`, 3 groups at T 768 from dispatch batch 32, one
    process a point) on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §6,
    the bench tools' readings), where neither flag has a losing regime, so
    no combination warns:

    - --quantize-weights: `bench_quant --variants f32,int8 --batch B
      --seq-len T`. int8 over f32 steps/s (best group) at dispatch batch
      2 / 8 / 16 / 32 / 64: T 32 1.101 / 1.28 / 1.646 / 1.688 / 2.095;
      T 128 1.233 / 1.773 / 2.205 / 2.18 / 2.35; T 768 1.856 / 2.071 /
      2.077 / 2.162 / 2.24. The chains are device-bound CUDA graphs, so
      int8 wins by its device time: its kernels fold the modulation, the
      gate and the residual, and f32's projections run as f32 SIMT GEMMs
      (the TPU's loss at batch 32 does not carry over).
    - --accel-interval: `bench_quant --variants f32 --accel-interval K
      --seq-len T` (dispatch batch 2), steps/s best / median group for K =
      1..5: T 32 622.4/622.3, 869.1/869.0, 1012/1011, 1093/1092,
      1152/1152; T 64 620.0/619.6, 872.0/871.6, 934.0/933.9, 1013/1012,
      1068/1068; T 128 491.2/491.0, 743.8/720.2, 872.5/870.6, 949.1/907.9,
      928.6/928.1. Every interval beats the exact chain, and a deeper one
      the shallower, except interval 5 against 4 at T 128, behind by the
      best group (-2.2%) and ahead by the median (+2.2%): no depth stops
      paying (the TPU's rule, deeper than 3 at T <= 32, does not carry
      over).

    The adaptive Δ-cache (`--accel-tau`) is not a parameter here, as in
    the JAX guardrail. Its chain is a CUDA graph too, the skip decided on
    the card (sampling.py): `bench_accel --taus 0,0.01,0.03,0.1,0.3,1.0
    --groups 3 --runs 3` (T 128) on the same card, steps/s over the exact
    chain's (full steps of 100): dispatch batch 2 0.978 (100), 0.972
    (100), 0.978 (99), 1.119 (79), 1.578 (34), 1.879 (16); batch 32 1.006,
    0.993, 1.014, 1.158 (77), 1.743, 2.144. A tau that skips at most one
    step pays the decision (~0.28 ms a step at DiT-B, T 768) for nothing
    and trails by up to 2.9%; any tau that skips more wins."""
    return []


def build_sample_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--beatmap", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--model", type=str, choices=list(DiT_models.keys()), default="DiT-B")
    parser.add_argument("--num-classes", type=int, default=52670)
    parser.add_argument("--beatmap-idx", type=str,
                        default=os.path.join("assets", "beatmap_idx.pickle"))
    parser.add_argument("--cfg-scale", type=float, default=1.0)
    parser.add_argument("--num-sampling-steps", type=int, default=250)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--seq-len", type=int, default=128,
                        help="attention band half-width (the training window)")
    parser.add_argument("--style-id", type=int, default=None)
    parser.add_argument("--plot-time", type=float, default=None,
                        help="trim the map to --seq-len points from this time (ms) and plot "
                             "each result there (needs matplotlib)")
    parser.add_argument("--plot-width", type=float, default=2000)
    parser.add_argument("--num-variants", type=int, default=1)
    parser.add_argument("--refine-ckpt", type=str, default=None,
                        help="a refine model (train_nodist_torch.py): after sampling, "
                             "--refine-iters t = 0 steps with its weights, written as a second "
                             ".osu per variant")
    parser.add_argument("--refine-iters", type=int, default=10)
    parser.add_argument("--compute-dtype", choices=["f32", "bf16"], default="f32",
                        help="the model's residual stream; the diffusion math and the model's "
                             "head stay f32 (bf16 is refused with --quantize-weights). bf16 is "
                             "slower end to end than f32 for now: every forward casts the "
                             "projections' f32 weights to bf16 again (ROADMAP.md Queue 1)")
    parser.add_argument("--results-dir", type=str, default="results")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--make-animation", action=argparse.BooleanOptionalAction, default=False,
                        help="with --plot-time: animation.gif of the denoising chain")
    parser.add_argument("--augment-flip", action=argparse.BooleanOptionalAction, default=False,
                        help="flip the map at random before sampling, as the reference's "
                             "sampler did (drawn from --seed)")
    parser.add_argument("--quantize-weights", action=argparse.BooleanOptionalAction, default=False,
                        help="serve int8 weight-only blocks (symmetric per-output-channel "
                             "absmax/127, quantized at load); embedders and final layer stay f32")
    parser.add_argument("--use-amp", action=argparse.BooleanOptionalAction, default=True,
                        help="accepted for the reference's flag surface; --compute-dtype sets "
                             "the stream")
    parser.add_argument("--sampling-method", type=str, default="ancestral",
                        choices=["ancestral", "ddim"])
    parser.add_argument("--accel-interval", type=int, default=1,
                        help="Δ-cache sampling (approximate): every block every Nth denoise "
                             "step and on the last, the cached middle-span residual in "
                             "between; 1 = exact sampling")
    parser.add_argument("--accel-span", type=int, nargs=2, default=None, metavar=("LO", "HI"),
                        help="block range [LO, HI) the Δ-cache covers (default: the middle "
                             "two-thirds of the depth)")
    parser.add_argument("--accel-tau", type=float, default=None,
                        help="adaptive Δ-cache: reuse the cached Δ while the model input's "
                             "relative drift since the last full step stays at or below TAU "
                             "(replaces the --accel-interval schedule)")
    parser.add_argument("--accel-max-skip", type=int, default=7,
                        help="adaptive Δ-cache: a full step after this many skips in a row")
    return parser


def load_model(ckpt: str, args, device) -> torch.nn.Module:
    """The f32 checkpoint as a DiT on `device` (int8 blocks under
    --quantize-weights), in eval mode."""
    kwargs = dict(num_classes=args.num_classes, context_size=CONTEXT_SIZE)
    if args.quantize_weights:
        model = restore_quantized(ckpt, DiT_models[args.model], **kwargs)
    else:
        model = DiT_models[args.model](**kwargs)
        model.load_state_dict(load_checkpoint(ckpt))
    return model.to(device).eval()


def _plot_axes():
    """A matplotlib figure and axes over the playfield (matplotlib is
    imported here only: the serving path does not need it)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.axis("equal")
    ax.set_xlim([0, 512])
    ax.set_ylim([384, 0])
    return plt, fig, ax


def sample_main(args) -> list[str]:
    """End-to-end beatmap generation; returns the paths written."""
    # the plain f32 parts (projections, embedders, head) run in full f32 on
    # the card, as the JAX f32 path does: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    beatmap = Beatmap.from_path(args.beatmap)
    filename = CLEAN_FILENAME_RX.sub("-", f"{beatmap.beatmap_id} {beatmap.artist} - {beatmap.title}")
    result_dir = os.path.join(args.results_dir, filename)
    os.makedirs(result_dir, exist_ok=True)

    seq_no_embed = beatmap_to_sequence(beatmap)  # (T, 19)
    if args.plot_time is not None:
        start = int(np.nonzero(seq_no_embed[:, 2] >= args.plot_time)[0][0])
        seq_no_embed = seq_no_embed[start:start + args.seq_len]
        print(f"Sequence trimmed to length {seq_no_embed.shape[0]}")
    seq = torch.from_numpy(seq_no_embed).to(device)
    if args.augment_flip:
        (_, seq_o, seq_c), seq_len = split_and_process_sequence(seq, generator=generator)
    else:
        (_, seq_o, seq_c), seq_len = split_and_process_sequence_no_augment(seq)
    seq_o = seq_o - seq_o[0]
    print(f"seq len {seq_len}")

    model = load_model(args.ckpt, args, device)
    diffusion = create_diffusion(
        str(args.num_sampling_steps), noise_schedule="squaredcos_cap_v2", device=device
    )

    if args.style_id is not None:
        idx = get_beatmap_idx(args.beatmap_idx)[args.style_id]
        class_labels = [idx + i for i in range(args.num_variants)]
    else:
        class_labels = [args.num_classes]

    # CFG doubles the dispatched batch
    serving_regime_warnings(args.quantize_weights, args.accel_interval, t_len=int(seq_len),
                            dispatch_batch=2 * len(class_labels))
    z, o, c, y = prepare_cfg_inputs(seq_o, seq_c, class_labels, args.num_classes, generator)
    sampler = Sampler(
        model, diffusion, cfg_scale=args.cfg_scale, band=args.seq_len,
        method=args.sampling_method,
        compute_dtype=torch.bfloat16 if args.compute_dtype == "bf16" else torch.float32,
        accel_interval=args.accel_interval,
        accel_span=tuple(args.accel_span) if args.accel_span else None,
        accel_tau=args.accel_tau, accel_max_skip=args.accel_max_skip,
    )

    n = len(class_labels)

    def to_seq(samples):
        coords = samples[:n].cpu().numpy()  # drop the null-class half
        rest = np.broadcast_to(seq_no_embed[None, :, 2:], (n, seq_len, 17))
        return np.concatenate([coords, rest], axis=-1)

    written: list[str] = []

    def save_sequence(sampled_seq, iteration=None):
        suffix = "" if iteration is None else f" {iteration}"
        for i, seq in enumerate(sampled_seq):
            try:
                new_beatmap = create_beatmap(
                    seq, beatmap, f"Diffusion {args.style_id} {i} {datetime.now()}{suffix}")
                out_path = os.path.join(
                    result_dir, f"{beatmap.beatmap_id} result {args.style_id} {i}{suffix}.osu")
                new_beatmap.write_path(out_path)
                written.append(out_path)
                if args.plot_time is not None:
                    plt, _, ax = _plot_axes()
                    plot_beatmap(ax, new_beatmap, args.plot_time, args.plot_width)
                    plt.show()
            except Exception as e:  # one undecodable variant must not lose the others
                logging.error("Failed to create beatmap.", exc_info=e)

    if args.plot_time is not None and args.make_animation:
        from matplotlib import animation

        frames = sampler.progressive(z, o, c, y, generator=generator)
        _, fig, ax = _plot_axes()
        artists = []
        for frame in frames:
            sampled_seq = to_seq(frame)
            frame_map = create_beatmap(sampled_seq[0], beatmap, f"Diffusion {args.style_id}")
            artists.append(plot_beatmap(ax, frame_map, args.plot_time, args.plot_width))
        ani = animation.ArtistAnimation(fig=fig, artists=artists, interval=1000 // 24)
        ani.save(filename=os.path.join(result_dir, "animation.gif"), writer="pillow")
        save_sequence(sampled_seq)
        return written

    samples = sampler(z, o, c, y, generator=generator)
    save_sequence(to_seq(samples))
    if args.refine_ckpt is not None:
        # the refine model's t = 0 steps over the samples, with the band of
        # the main chain and the f32 stream (as the JAX CLI runs it)
        refiner = Sampler(load_model(args.refine_ckpt, args, device), diffusion,
                          cfg_scale=args.cfg_scale, band=args.seq_len)
        save_sequence(to_seq(refiner.refine(samples, o, c, y, args.refine_iters,
                                            generator=generator)), args.refine_iters)
    return written


def build_train_parser() -> argparse.ArgumentParser:
    d = TrainConfig(data_path="")
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-path", type=str, required=True)
    parser.add_argument("--num-classes", type=int, default=d.num_classes)
    parser.add_argument("--data-start", type=int, default=d.data_start)
    parser.add_argument("--data-end", type=int, default=d.data_end)
    parser.add_argument("--results-dir", type=str, default=d.results_dir)
    parser.add_argument("--model", type=str, choices=list(DiT_models.keys()), default=d.model)
    parser.add_argument("--epochs", type=int, default=d.epochs)
    parser.add_argument("--global-batch-size", type=int, default=d.global_batch_size)
    parser.add_argument("--global-seed", type=int, default=d.global_seed)
    parser.add_argument("--num-workers", type=int, default=d.num_workers)
    parser.add_argument("--log-every", type=int, default=d.log_every)
    parser.add_argument("--ckpt-every", type=int, default=d.ckpt_every)
    parser.add_argument("--seq-len", type=int, default=d.seq_len,
                        help="training window; also the attention band")
    parser.add_argument("--stride", type=int, default=d.stride)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="resume from this .pt (model, ema, opt and step where present)")
    parser.add_argument("--noise-schedule", type=str, default=d.noise_schedule)
    parser.add_argument("--lr", type=float, default=d.lr)
    parser.add_argument("--embed-only-epochs", type=int, default=d.embed_only_epochs,
                        help="train only the label table for this many epochs first")
    parser.add_argument("--relearn-embeds", action=argparse.BooleanOptionalAction,
                        default=d.relearn_embeds,
                        help="with --ckpt: keep a freshly initialised label table (the "
                             "checkpoint's may have another class count) and start a fresh "
                             "optimizer at step 0")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--steps-per-call", type=int, default=d.steps_per_call,
                        help="optimizer steps a call (one CUDA graph on a card in one process); "
                             "the log, checkpoint and stop tests run at a call's end")
    parser.add_argument("--l1-loss", action=argparse.BooleanOptionalAction, default=d.l1_loss)
    parser.add_argument("--use-bf16", action=argparse.BooleanOptionalAction, default=d.use_bf16,
                        help="bf16 residual stream over f32 master weights")
    parser.add_argument("--use-amp", action=argparse.BooleanOptionalAction, default=None,
                        help="the reference's name for --use-bf16; overrides it when given")
    parser.add_argument("--fine-tune-ids", type=str, default=None,
                        help="accepted for flag parity with the reference, which never uses it")
    parser.add_argument("--profile-dir", type=str, default=d.profile_dir,
                        help="write a torch.profiler trace of the first optimizer steps here")
    parser.add_argument("--remat", action=argparse.BooleanOptionalAction, default=d.remat,
                        help="recompute each block in the backward")
    parser.add_argument("--mlp-bwd", choices=["fused", "xla"], default=d.mlp_bwd,
                        help="the adaLN-MLP backward: the plain 'xla' (default) or the "
                             "fused reduction/LayerNorm-backward kernels")
    parser.add_argument("--device", type=str, default=d.device)
    parser.add_argument("--num-model", type=int, default=d.num_model,
                        help="ranks on the mesh's model axis: they shard the MLPs, the adaLN "
                             "heads and the label table (tensor parallelism), with "
                             "--context-parallel also splitting one window's sequence")
    parser.add_argument("--context-parallel", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="split the sequence over the --num-model ranks (seq-len a multiple "
                             "of num-model * 128); attention exchanges band-sized halos")
    parser.add_argument("--band", type=int, default=d.band,
                        help="attention half-width (default: --seq-len, full attention)")
    parser.add_argument("--dist", dest="dist_backend", choices=["nccl", "gloo"],
                        default=d.dist_backend,
                        help="torch.distributed backend under torchrun (default: nccl on CUDA, "
                             "gloo on the CPU)")
    return parser


def check_context_parallel(args) -> None:
    """--context-parallel splits the sequence over the model ranks, so it
    needs --num-model > 1 (--num-model alone is tensor parallelism)."""
    if args.context_parallel and args.num_model < 2:
        raise ValueError("--context-parallel splits the sequence over the mesh's model axis: "
                         "it needs --num-model > 1")


def train_config_kwargs(args) -> dict:
    """Parsed train-CLI arguments -> TrainConfig keyword arguments (the
    context-parallel flags checked). Shared by train_main and
    train_nodist_torch.py (which adds max_timestep=1), so the two cannot
    drift when flags are added."""
    check_context_parallel(args)
    return dict(
        data_path=args.data_path, num_classes=args.num_classes, data_start=args.data_start,
        data_end=args.data_end, results_dir=args.results_dir, model=args.model,
        epochs=args.epochs, global_batch_size=args.global_batch_size,
        global_seed=args.global_seed, num_workers=args.num_workers, log_every=args.log_every,
        ckpt_every=args.ckpt_every, seq_len=args.seq_len, stride=args.stride, ckpt=args.ckpt,
        noise_schedule=args.noise_schedule, l1_loss=args.l1_loss, lr=args.lr,
        relearn_embeds=args.relearn_embeds, embed_only_epochs=args.embed_only_epochs,
        use_bf16=args.use_bf16 if args.use_amp is None else args.use_amp, remat=args.remat,
        max_steps=args.max_steps, steps_per_call=args.steps_per_call, mlp_bwd=args.mlp_bwd,
        device=args.device,
        num_model=args.num_model, context_parallel=args.context_parallel, band=args.band,
        dist_backend=args.dist_backend,
        profile_dir=args.profile_dir,
    )


def train_main(args) -> dict:
    """Train from parsed `build_train_parser` arguments."""
    return train(TrainConfig(**train_config_kwargs(args)))
