"""The training loop (port of osu_diffusion_tpu/train/trainer.py, one device).

- An experiment directory `<results_dir>/NNN-<model>/` with `log.txt` and
  `checkpoints/<step, 7 digits>.pt` every `ckpt_every` steps.
- The loader of data/dataset.py over `TrackNNNNN/beatmaps/` in
  [data_start, data_end), raw windows of `seq_len` with `stride`, whole
  batches (the last partial batch dropped); featurization, flips and time
  offsets run on the device in the step.
- The log line "(step=…) Train Loss: x, Train Steps/Sec: y" every
  `log_every` steps (evals/plot_loss.py reads it), then "Done!".
- Resume from `ckpt`: model, EMA, optimizer state and step, where the file
  has them. With `relearn_embeds` the label table keeps its fresh seeded
  initialisation (the file's may have another class count) and the run
  starts a fresh optimizer at step 0, as the JAX trainer does from a `.pt`.
- `embed_only_epochs`: the first N epochs train the label table alone (the
  other parameters frozen, JAX `_embed_mask`); `max_timestep` caps the
  timestep draw (1: the refine model of train_nodist_torch.py).

On a CUDA device every block runs the training kernels: the banded
attention forward with LSE and its dq and dk/dv kernels at band =
`seq_len` (exactly full attention at T = seq_len), and the fused adaLN-MLP
forward with residuals, and with `mlp_bwd="fused"` its two backward
kernels.
"""
from __future__ import annotations

import dataclasses
import os
import time
from glob import glob

import torch

from osu_diffusion_tpu_torch import CONTEXT_SIZE
from osu_diffusion_tpu_torch.data.dataset import BeatmapDatasetIterableFactory, get_data_loader
from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
from osu_diffusion_tpu_torch.models.dit import DiT_models
from osu_diffusion_tpu_torch.train import checkpoint as ckpt_lib
from osu_diffusion_tpu_torch.train.train_step import make_ema, make_optimizer, train_step
from osu_diffusion_tpu_torch.utils.logger import create_logger


@dataclasses.dataclass
class TrainConfig:
    """The reference trainer's flags that the port takes (its defaults)."""

    data_path: str
    num_classes: int = 52670
    data_start: int = 0
    data_end: int = 13402
    results_dir: str = "results"
    model: str = "DiT-B"
    epochs: int = 1400
    global_batch_size: int = 256
    global_seed: int = 0
    num_workers: int = 4
    log_every: int = 100
    ckpt_every: int = 50_000
    seq_len: int = 128
    stride: int = 16
    ckpt: str | None = None
    noise_schedule: str = "squaredcos_cap_v2"
    l1_loss: bool = True
    lr: float = 1e-4
    relearn_embeds: bool = False
    embed_only_epochs: int = 0
    use_bf16: bool = True  # a bf16 residual stream over f32 master weights
    remat: bool = True  # recompute each block in the backward
    max_steps: int | None = None  # optional hard stop
    max_timestep: int | None = None  # cap the timestep draw; 1 = refine-model mode
    mlp_bwd: str = "xla"  # the MLP half's backward: "xla" (plain) or "fused" (kernels)
    device: str = "cuda"


CLASS_DROPOUT_PROB = 0.2  # the reference trainer's label dropout (the DiT default is 0.1)
LABEL_TABLE = "y_embedder.embedding_table.weight"


def embed_only_mask(model) -> dict[str, bool]:
    """Trainable: the label table alone (JAX `_embed_mask(params, True)`)."""
    return {name: "embedding_table" in name for name, _ in model.named_parameters()}


def _load_state(config: TrainConfig, model, ema, optimizer, logger) -> int:
    """Restore from config.ckpt where the file has each part; returns the
    step to continue from. With relearn_embeds: the weights without the
    label table, and step 0 with the fresh optimizer."""
    ckpt = ckpt_lib.load_train_checkpoint(config.ckpt)
    if "model" in ckpt or "ema" in ckpt:
        model_sd, ema_sd = ckpt.get("model", ckpt.get("ema")), ckpt.get("ema", ckpt.get("model"))
    else:  # a raw state dict
        model_sd = ema_sd = ckpt
    if config.relearn_embeds:
        model_sd = {**model_sd, LABEL_TABLE: model.state_dict()[LABEL_TABLE]}
        ema_sd = {**ema_sd, LABEL_TABLE: ema.state_dict()[LABEL_TABLE]}
    model.load_state_dict(model_sd)
    ema.load_state_dict(ema_sd)
    if config.relearn_embeds:
        logger.info(f"Restored from checkpoint at {config.ckpt} (label table re-initialised)")
        return 0
    if "opt" in ckpt:
        optimizer.load_state_dict(ckpt["opt"])
    logger.info(f"Restored from checkpoint at {config.ckpt}")
    return int(ckpt.get("step", 0))


def train(config: TrainConfig) -> dict:
    """Run training; returns a summary {final_step, last_loss,
    experiment_dir, checkpoint_dir}."""
    device = torch.device(config.device)
    # f32 products in full f32, and bf16 products with f32 reductions, as
    # the JAX package computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    os.makedirs(config.results_dir, exist_ok=True)
    experiment_index = len(glob(f"{config.results_dir}/*"))
    experiment_dir = f"{config.results_dir}/{experiment_index:03d}-{config.model.replace('/', '-')}"
    checkpoint_dir = f"{experiment_dir}/checkpoints"
    os.makedirs(checkpoint_dir, exist_ok=True)
    logger = create_logger(experiment_dir)
    logger.info(f"Experiment directory created at {experiment_dir}")

    model = DiT_models[config.model](
        num_classes=config.num_classes, context_size=CONTEXT_SIZE,
        class_dropout_prob=CLASS_DROPOUT_PROB, remat=config.remat, mlp_bwd=config.mlp_bwd,
    )
    model.initialize_weights(torch.Generator().manual_seed(config.global_seed))
    model.to(device).train()
    ema = make_ema(model).eval()
    optimizer = make_optimizer(model.parameters(), lr=config.lr)
    logger.info(f"DiT Parameters: {sum(p.numel() for p in model.parameters()):,}")
    diffusion = create_diffusion("", noise_schedule=config.noise_schedule,
                                 use_l1=config.l1_loss, device=device)
    dtype = torch.bfloat16 if config.use_bf16 else torch.float32
    train_steps = _load_state(config, model, ema, optimizer, logger) if config.ckpt else 0

    loader = get_data_loader(
        dataset_path=config.data_path, start=config.data_start, end=config.data_end,
        iterable_factory=BeatmapDatasetIterableFactory(config.seq_len, config.stride,
                                                       seed=config.global_seed),
        cycle_length=max(1, config.global_batch_size // 2),
        batch_size=config.global_batch_size, num_workers=config.num_workers,
        shuffle=True, drop_last=True, seed=config.global_seed,
    )
    logger.info(f"Dataset contains {config.data_end - config.data_start:,} beatmap sets "
                f"({config.data_path})")
    generator = torch.Generator(device=device).manual_seed(config.global_seed + train_steps)
    args = dataclasses.asdict(config)

    embed_only = config.embed_only_epochs > 0
    if embed_only:
        logger.info(f"Freezing non-embedding layers for {config.embed_only_epochs} epochs")

    log_steps = 0
    running_loss = torch.zeros((), device=device)
    last_avg_loss = float("nan")
    start_time = time.time()
    logger.info(f"Training for {config.epochs} epochs...")
    stop = config.max_steps is not None and train_steps >= config.max_steps
    for epoch in range(config.epochs):
        if stop:
            break
        logger.info(f"Beginning epoch {epoch}...")
        if embed_only and epoch == config.embed_only_epochs:
            logger.info("Un-freezing non-embedding layers")
            embed_only = False
        mask = embed_only_mask(model) if embed_only else None
        for (win, prev_xy), y in loader:
            batch = tuple(torch.from_numpy(a).to(device, non_blocking=True) for a in (win, prev_xy, y))
            metrics = train_step(
                model, ema, optimizer, diffusion, (batch[0], batch[1], batch[2].long()),
                band=config.seq_len, dtype=dtype, generator=generator,
                max_timestep=config.max_timestep, trainable_mask=mask,
            )
            running_loss += metrics["loss"]
            log_steps += 1
            train_steps += 1
            if train_steps % config.log_every == 0:
                last_avg_loss = running_loss.item() / log_steps  # the one host sync
                steps_per_sec = log_steps / (time.time() - start_time)
                logger.info(f"(step={train_steps:07d}) Train Loss: {last_avg_loss:.4f}, "
                            f"Train Steps/Sec: {steps_per_sec:.2f}")
                running_loss.zero_()
                log_steps = 0
                start_time = time.time()
            if train_steps % config.ckpt_every == 0:
                path = ckpt_lib.save_checkpoint(checkpoint_dir, train_steps, model, ema, optimizer, args)
                logger.info(f"Saved checkpoint to {path}")
            if config.max_steps is not None and train_steps >= config.max_steps:
                stop = True
                break

    logger.info("Done!")
    return {"final_step": train_steps, "last_loss": last_avg_loss,
            "experiment_dir": experiment_dir, "checkpoint_dir": checkpoint_dir}
