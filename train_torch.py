#!/usr/bin/env python
"""Train a DiT on a Track dataset with the PyTorch + CUDA port; see
osu_diffusion_tpu_torch/cli.py and osu_diffusion_tpu_torch/train/trainer.py."""
from osu_diffusion_tpu_torch.cli import build_train_parser, train_main

if __name__ == "__main__":
    train_main(build_train_parser().parse_args())
