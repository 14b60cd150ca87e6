"""Beatmap export: the port's own copy of osu_diffusion_tpu/export/."""
from osu_diffusion_tpu_torch.export.create_beatmap import (
    create_beatmap,
    plot_beatmap,
    position_to_progress,
)

__all__ = ["create_beatmap", "plot_beatmap", "position_to_progress"]
