#!/usr/bin/env python
"""Train the refine model with the PyTorch + CUDA port: the train command's
loop and flags with the timestep draw pinned to t = 0 (max_timestep=1), the
model that sampling's refine step uses. See osu_diffusion_tpu_torch/cli.py."""
from osu_diffusion_tpu_torch.cli import build_train_parser, train_config_kwargs
from osu_diffusion_tpu_torch.train.trainer import TrainConfig, train

if __name__ == "__main__":
    args = build_train_parser().parse_args()
    train(TrainConfig(**{**train_config_kwargs(args), "max_timestep": 1}))
