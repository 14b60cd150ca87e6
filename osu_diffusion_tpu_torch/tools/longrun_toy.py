"""Long learning run on the toy fixtures with periodic in-paint eval (port of
tools/longrun_toy.py).

Alternates training chunks (the port's trainer, checkpoint/resume between
chunks) with the reference's test_toy in-paint accuracy protocol
(evals/toy.py, parity testing/test_toy.py:161-190) on the EMA weights,
appending one JSON line per eval round to --log.

The toy training set is synthesized from assets/toy_datasets into the
Track structure the loader expects; labels are per-fixture (one style class
per file), matching how the reference's label-per-beatmap training works.

Run from the repository root:
  python -m osu_diffusion_tpu_torch.tools.longrun_toy --seq-len 128 --stride 16 --pad-rows 160
On the card (the default `--device cuda`) every training step runs the
training kernels and every eval chain the inference kernels; `--device cpu`
runs the plain versions. `--steps-per-call k` goes to the trainer (k
optimizer steps a call, one CUDA graph on the card), as the JAX tool
passes it; its default is 1, not the JAX tool's 32 (train/trainer.py says
why). A chunk then ends at the first call boundary at or past its target.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from glob import glob


def _kimi_tail(kimi_path: str, min_rows: int):
    """Smallest suffix of the filler map with >= min_rows datapoints."""
    import dataclasses

    from osu_diffusion_tpu_torch.beatmap import Beatmap
    from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence

    bm = Beatmap.from_path(kimi_path)
    objs = bm.hit_objects()
    k = max(8, min_rows // 2)
    while True:
        cand = dataclasses.replace(bm, _hit_objects=objs[-k:])
        if k >= len(objs) or beatmap_to_sequence(cand).shape[0] >= min_rows:
            return cand
        # additive growth keeps the tail tight: extra filler rows dilute the
        # per-window pattern signal (every padded file shares this tail)
        k = min(len(objs), k + 16)


def _pad_with_filler(fix_bm, tail_bm, gap_ms: float = 300.0):
    """One beatmap: filler tail, then the fixture time-shifted to start
    gap_ms after it — the FILE-level analogue of the eval protocol's
    sequence padding (evals/toy.example_from_beatmap: filler_add rows in
    front, pattern re-based +300 ms). Both maps keep their own timing
    points (the fixture's are shifted with its objects), so the fixture's
    sliders stay governed by their original red/green lines."""
    import dataclasses
    from datetime import timedelta

    tail_objs = tail_bm.hit_objects()
    tail_end = max(
        max(o.time, getattr(o, "end_time", o.time)) for o in tail_objs
    )
    fix_objs = fix_bm.hit_objects()
    delta = tail_end + timedelta(milliseconds=gap_ms) - fix_objs[0].time

    def shift_obj(o):
        kw = {"time": o.time + delta}
        if hasattr(o, "end_time"):
            kw["end_time"] = o.end_time + delta
        return dataclasses.replace(o, **kw)

    # The combined file keeps the FIXTURE's SliderMultiplier (its geometry is
    # the training signal and must stay bit-identical), so the filler tail's
    # slider velocities are rescaled to preserve its slider durations:
    # duration = length * beat / (SM * 100 * sv), hence sv' = sv * SMk / SMf
    # (ms_per_beat_green' = ms_per_beat_green * SMf / SMk), with a companion
    # green line after each red (which alone implies sv = 1).
    sm_ratio = fix_bm.slider_multiplier / tail_bm.slider_multiplier
    tail_tps = []
    for tp in tail_bm.timing_points:
        if tp.parent is None:  # red: keep, then pin the sv with a green
            tail_tps.append(tp)
            if abs(sm_ratio - 1.0) > 1e-12:
                tail_tps.append(
                    dataclasses.replace(
                        tp, ms_per_beat=-100.0 * sm_ratio, parent=tp
                    )
                )
        else:  # green: rescale the raw negative SV field
            tail_tps.append(
                dataclasses.replace(tp, ms_per_beat=tp.ms_per_beat * sm_ratio)
            )
    # parent links are rebuilt when the loader re-parses the written file, so
    # only offsets need shifting. A fixture timing point that precedes its
    # first OBJECT by more than gap_ms would land inside the filler tail
    # after the shift and re-govern tail sliders (corrupting their
    # durations) — clamp shifted offsets to just past the tail. Clamped
    # points keep their relative order (sorted input, stable sort on
    # re-parse), and every fixture object sits at >= seam + gap_ms, so
    # governance over the fixture is unchanged.
    seam_floor = tail_end + timedelta(milliseconds=1)
    new_tps = tail_tps + [
        dataclasses.replace(tp, offset=max(tp.offset + delta, seam_floor))
        for tp in fix_bm.timing_points
    ]
    new_objs = list(tail_objs) + [shift_obj(o) for o in fix_objs]
    return dataclasses.replace(
        fix_bm, _hit_objects=new_objs, timing_points=new_tps
    )


def build_dataset(root: str, assets: str, pad_rows: int | None = None) -> int:
    """All 4 suites + filler as TrackNNNNN/beatmaps/NNNNNN files; returns the
    number of classes (files).

    pad_rows: fixtures shorter than this many datapoints are prepended with a
    filler (kimi) tail at the FILE level so window-`seq_len` training works at
    the reference protocol's seq_len 128 (train.py:321) — without it the toy
    fixtures (4-34 datapoints) yield zero 128-windows and epochs are empty."""
    if os.path.exists(root):
        shutil.rmtree(root)
    suites = ["geometry", "stream", "symmetry", "visual_spacing"]
    files = []
    for s in suites:
        files += sorted(glob(os.path.join(assets, s, "*.osu")))
    kimi = os.path.join(assets, "kimi_no_bouken.osu")
    files.append(kimi)
    tail_bm = None
    if pad_rows is not None:
        from osu_diffusion_tpu_torch.beatmap import Beatmap
        from osu_diffusion_tpu_torch.beatmap.writer import write_beatmap_file
        from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence

        tail_bm = _kimi_tail(kimi, pad_rows)
    n_tracks = 8
    for i, f in enumerate(files):
        d = os.path.join(root, f"Track{i % n_tracks:05d}", "beatmaps")
        os.makedirs(d, exist_ok=True)
        dest = os.path.join(d, f"{i:06d} {os.path.basename(f)}")
        if tail_bm is not None and f != kimi:
            bm = Beatmap.from_path(f)
            if beatmap_to_sequence(bm).shape[0] < pad_rows:
                write_beatmap_file(_pad_with_filler(bm, tail_bm), dest)
                continue
        shutil.copy(f, dest)
    return len(files)


def _checkpoint_step(path: str) -> int:
    """The step of a `<step, 7 digits>.pt` checkpoint, from its name."""
    return int(os.path.splitext(os.path.basename(path))[0])


def main(argv=None) -> None:
    from osu_diffusion_tpu_torch.models.dit import DiT_models

    parser = argparse.ArgumentParser()
    parser.add_argument("--total-steps", type=int, default=400_000)
    parser.add_argument("--chunk", type=int, default=25_000)
    parser.add_argument("--model", type=str, choices=list(DiT_models.keys()), default="DiT-S")
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--seq-len", type=int, default=32)
    parser.add_argument("--stride", type=int, default=8)
    parser.add_argument("--steps-per-call", type=int, default=1)
    parser.add_argument("--num-predictions", type=int, default=100)
    parser.add_argument("--num-sampling-steps", type=int, default=1000)
    parser.add_argument("--suites", type=str, nargs="*",
                        default=["stream", "geometry", "symmetry", "visual_spacing"])
    parser.add_argument("--results-dir", type=str,
                        default=os.path.join("results", "longrun_results"))
    parser.add_argument("--data-dir", type=str, default=os.path.join("results", "longrun_toy_ds"))
    parser.add_argument("--log", type=str, default=os.path.join("results", "longrun_evals.jsonl"))
    parser.add_argument("--wall-limit-s", type=float, default=10 ** 9)
    parser.add_argument("--eval-timeout-s", type=float, default=1200,
                        help="per-SUITE hang watchdog: dump all stacks and "
                             "exit if one suite eval stalls this long")
    parser.add_argument("--resume-from", type=str, default=None,
                        help="explicit checkpoint to resume from (overrides "
                             "the newest-experiment auto-scan)")
    parser.add_argument("--pad-rows", type=int, default=None,
                        help="pad fixtures shorter than this many datapoints "
                             "with a filler tail at dataset-build time "
                             "(required for --seq-len 128 training; use e.g. "
                             "160 so most windows include pattern content)")
    parser.add_argument("--lr-points", type=str, default=None,
                        help="comma list of step:lr decay points, e.g. "
                             "'0:1e-4,150000:3e-5,250000:1e-5' — each chunk "
                             "uses the lr of the last point <= its start step "
                             "(the reference's lr-override-on-resume flow, "
                             "train.py:221)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    lr_points = [(0, 1e-4)]
    if args.lr_points:
        lr_points = sorted(
            (int(p.split(":")[0]), float(p.split(":")[1]))
            for p in args.lr_points.split(",")
        )

    def lr_at(step: int) -> float:
        lr = lr_points[0][1]
        for s0, v in lr_points:
            if step >= s0:
                lr = v
        return lr

    import torch

    from osu_diffusion_tpu_torch import CONTEXT_SIZE
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.evals.toy import evaluate_suite
    from osu_diffusion_tpu_torch.sampling import Sampler
    from osu_diffusion_tpu_torch.train.checkpoint import latest_checkpoint
    from osu_diffusion_tpu_torch.train.trainer import TrainConfig, train

    device = torch.device(args.device)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assets = os.path.join(here, "assets", "toy_datasets")
    num_classes = build_dataset(args.data_dir, assets, pad_rows=args.pad_rows)
    n_tracks = len(glob(os.path.join(args.data_dir, "Track*")))
    print(f"dataset: {num_classes} fixtures over {n_tracks} tracks", flush=True)

    eval_model = DiT_models[args.model](
        num_classes=num_classes, context_size=CONTEXT_SIZE
    ).to(device).eval()
    eval_diffusion = create_diffusion(
        str(args.num_sampling_steps), noise_schedule="squaredcos_cap_v2", device=device
    )
    # band = TRAIN window (the reference's banded-extrapolation rule,
    # sample.py --seq-len semantics): a model trained on seq_len-long windows
    # must not attend beyond seq_len neighbors at eval
    sampler = Sampler(eval_model, eval_diffusion, band=args.seq_len)

    def run_eval(step: int, ema, t_train: float) -> None:
        # hang watchdog, re-armed per SUITE: if ONE suite exceeds
        # eval_timeout_s, dump every thread's Python stack to stderr and exit
        # nonzero; the chunk checkpoint is already saved, so a relauncher
        # resumes cleanly at the next chunk.
        import faulthandler

        eval_model.load_state_dict(ema.state_dict())
        generator = torch.Generator(device=device).manual_seed(step)
        rec = {"step": step, "train_s": round(t_train, 1)}
        t0 = time.time()
        for suite in args.suites:
            faulthandler.dump_traceback_later(args.eval_timeout_s, exit=True)
            # seq_len pinned to the reference protocol (test_toy pads every
            # example to seq_len with filler, SURVEY §3.4)
            res = evaluate_suite(
                sampler, suite, args.num_predictions, num_classes, 128, generator,
            )
            rec[suite] = round(res["accuracy"], 4)
        rec["eval_s"] = round(time.time() - t0, 1)
        faulthandler.cancel_dump_traceback_later()
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        with open(args.log, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)

    t_start = time.time()
    step = 0
    ckpt = None
    # resume an interrupted run: newest step of the newest experiment
    for exp in sorted(glob(os.path.join(args.results_dir, "*", "checkpoints"))):
        latest = latest_checkpoint(exp)
        if latest is not None:
            ckpt = latest
            # chunk targets count from the restored step, else the first
            # chunk's max_steps is already behind the checkpoint
            step = _checkpoint_step(latest)
    if args.resume_from:
        ckpt = args.resume_from
        step = _checkpoint_step(ckpt)
    while step < args.total_steps:
        target = min(step + args.chunk, args.total_steps)
        cfg = TrainConfig(
            data_path=args.data_dir,
            num_classes=num_classes,
            data_start=0,
            data_end=n_tracks,
            results_dir=args.results_dir,
            model=args.model,
            epochs=10 ** 9,
            global_batch_size=args.batch,
            # toy fixtures are SHORTER than the standard 128 window; at
            # seq_len 128 only the filler map yields windows unless
            # --pad-rows pads them. 32/8 (the defaults) is the short-window
            # learning-sanity setup.
            seq_len=args.seq_len,
            stride=args.stride,
            num_workers=2,
            log_every=1000,
            ckpt_every=args.chunk,
            ckpt=ckpt,
            max_steps=target,
            steps_per_call=args.steps_per_call,
            lr=lr_at(step),
            device=args.device,
        )
        t0 = time.time()
        out = train(cfg)
        step = out["final_step"]
        ckpt = latest_checkpoint(out["checkpoint_dir"])
        run_eval(step, out["ema"], time.time() - t0)
        del out
        import gc

        gc.collect()
        with open("/proc/self/status") as f:
            rss_kb = next(
                int(line.split()[1]) for line in f if line.startswith("VmRSS")
            )
        print(f"post-chunk rss_gb={rss_kb / 1e6:.1f}", flush=True)
        if time.time() - t_start > args.wall_limit_s:
            print("wall limit reached", flush=True)
            break
    print("longrun done", flush=True)


if __name__ == "__main__":
    main()
