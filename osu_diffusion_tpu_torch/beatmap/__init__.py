"""Beatmap I/O layer (L0): the port's own copy of osu_diffusion_tpu/beatmap/
(objects, curves, parser, writer), so the port imports nothing of the JAX
package.

The reference delegates .osu parsing/writing to the external `slider` pip
package (reference requirements.txt:4, data_loading.py:18-26). This framework is
standalone: osu_diffusion_tpu_torch.beatmap implements the subset of the osu! file
format the pipeline needs — hit objects (circles/sliders/spinners), timing
points with inheritance, metadata/difficulty sections, and slider curve
geometry — with API names mirroring the concepts the reference code uses
(Beatmap.from_path / write_path, HitObject/Slider/Spinner/TimingPoint,
Curve.from_kind_and_points).
"""
from osu_diffusion_tpu_torch.beatmap.objects import (
    Beatmap,
    Circle,
    Curve,
    HitObject,
    Position,
    Slider,
    Spinner,
    TimingPoint,
    Linear,
    Catmull,
    Perfect,
    MultiBezier,
)

__all__ = [
    "Beatmap",
    "Circle",
    "Curve",
    "HitObject",
    "Position",
    "Slider",
    "Spinner",
    "TimingPoint",
    "Linear",
    "Catmull",
    "Perfect",
    "MultiBezier",
]
