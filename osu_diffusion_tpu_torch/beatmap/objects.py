"""Beatmap object model.

Standalone replacement for the subset of the `slider` package's object model the
reference uses (slider.beatmap.Beatmap/HitObject/Slider/Spinner/TimingPoint,
slider.curve.*, slider.Position — see reference data_loading.py:18-26,
export/create_beatmap.py:7-19). API names mirror those concepts so the rest of
the framework reads like the reference's call sites, but this is an independent
implementation backed by osu_diffusion_tpu_torch.beatmap.curves.
"""
from __future__ import annotations

import dataclasses
from datetime import timedelta
from typing import Optional

import numpy as np

from osu_diffusion_tpu_torch.beatmap.curves import SliderPath


@dataclasses.dataclass(frozen=True)
class Position:
    x: float
    y: float

    def __iter__(self):
        yield self.x
        yield self.y

    def __eq__(self, other):
        return isinstance(other, Position) and self.x == other.x and self.y == other.y


@dataclasses.dataclass
class TimingPoint:
    """One timing point. `parent is None` => uninherited (red line, ms_per_beat
    is the true beat length); otherwise inherited (green line, ms_per_beat is
    the raw negative SV field: sv_multiplier = -100 / ms_per_beat)."""

    offset: timedelta
    ms_per_beat: float
    meter: int
    sample_type: int
    sample_set: int
    volume: int
    parent: Optional["TimingPoint"]
    kiai_mode: bool

    @property
    def sv_multiplier(self) -> float:
        if self.parent is not None and self.ms_per_beat < 0:
            return -100.0 / self.ms_per_beat
        return 1.0


# ---------------------------------------------------------------------------
# curves (slider.curve API surface)
# ---------------------------------------------------------------------------


class Curve:
    """A slider curve: control points (head included), kind, required length.

    Calling the curve with a progress in [0, 1] returns the Position that far
    along the first span (arc-length parameterized, trimmed/extended to
    req_length) — the behavior the featurizer relies on for slider end
    positions (reference data_loading.py:100).
    """

    kind = "B"
    _path_type = "Bezier"

    def __init__(self, points: list[Position], req_length: float):
        self.points = list(points)
        self.req_length = req_length
        self._path: SliderPath | None = None

    @staticmethod
    def from_kind_and_points(kind: str, points: list[Position], req_length: float) -> "Curve":
        cls = {"B": MultiBezier, "L": Linear, "C": Catmull, "P": Perfect}.get(kind)
        if cls is None:
            raise ValueError(f"unknown curve kind: {kind!r}")
        if cls is Perfect and len(points) != 3:
            cls = MultiBezier  # osu! degrades non-3-point perfect curves to bezier
        return cls(points, req_length)

    @property
    def path(self) -> SliderPath:
        if self._path is None:
            cps = np.array([[p.x, p.y] for p in self.points], dtype=float)
            self._path = SliderPath(self._path_type, cps, self.req_length)
        return self._path

    def __call__(self, progress: float) -> Position:
        p = self.path.position_at(progress)
        return Position(float(p[0]), float(p[1]))


class MultiBezier(Curve):
    kind = "B"
    _path_type = "Bezier"


class Linear(Curve):
    kind = "L"
    _path_type = "Linear"


class Catmull(Curve):
    kind = "C"
    _path_type = "Catmull"


class Perfect(Curve):
    kind = "P"
    _path_type = "PerfectCurve"


# ---------------------------------------------------------------------------
# hit objects
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HitObject:
    position: Position
    time: timedelta
    hitsound: int
    new_combo: bool = False
    combo_skip: int = 0


@dataclasses.dataclass
class Circle(HitObject):
    pass


@dataclasses.dataclass
class Spinner(HitObject):
    end_time: timedelta = timedelta()


@dataclasses.dataclass
class Slider(HitObject):
    end_time: timedelta = timedelta()
    curve: Curve = None
    repeat: int = 1
    length: float = 0.0
    ticks: int = 0
    num_beats: float = 0
    tick_rate: float = 1.0
    ms_per_beat: float = 500.0
    edge_sounds: list = dataclasses.field(default_factory=list)
    edge_additions: list = dataclasses.field(default_factory=list)


def _circle(position, time, hitsound=0, new_combo=False, combo_skip=0):
    return Circle(position, time, hitsound, new_combo, combo_skip)


# keyword-friendly Slider constructor mirroring the call sites in the decode
# layer (reference export/create_beatmap.py:48-64 passes these by name)
def make_slider(
    *,
    position,
    time,
    end_time,
    hitsound=0,
    curve=None,
    repeat=1,
    length=0.0,
    ticks=0,
    num_beats=0,
    tick_rate=1.0,
    ms_per_beat=500.0,
    edge_sounds=(),
    edge_additions=(),
    new_combo=False,
    combo_skip=0,
) -> Slider:
    return Slider(
        position=position,
        time=time,
        hitsound=hitsound,
        new_combo=new_combo,
        combo_skip=combo_skip,
        end_time=end_time,
        curve=curve,
        repeat=repeat,
        length=length,
        ticks=ticks,
        num_beats=num_beats,
        tick_rate=tick_rate,
        ms_per_beat=ms_per_beat,
        edge_sounds=list(edge_sounds),
        edge_additions=list(edge_additions),
    )


# ---------------------------------------------------------------------------
# beatmap
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Beatmap:
    format_version: int = 14
    # [General]
    audio_filename: str = "audio.mp3"
    audio_lead_in: int = 0
    preview_time: int = -1
    countdown: int = 0
    sample_set: str = "Normal"
    stack_leniency: float = 0.7
    mode: int = 0
    letterbox_in_breaks: bool = False
    widescreen_storyboard: bool = False
    # [Editor]
    bookmarks: list = dataclasses.field(default_factory=list)
    distance_spacing: float = 1.0
    beat_divisor: int = 4
    grid_size: int = 4
    timeline_zoom: float = 1.0
    # [Metadata]
    title: str = ""
    title_unicode: str = ""
    artist: str = ""
    artist_unicode: str = ""
    creator: str = ""
    version: str = ""
    source: str = ""
    tags: list = dataclasses.field(default_factory=list)
    beatmap_id: int = 0
    beatmap_set_id: int = -1
    # [Difficulty]
    hp_drain_rate: float = 5.0
    circle_size: float = 5.0
    overall_difficulty: float = 5.0
    approach_rate: float = 5.0
    slider_multiplier: float = 1.4
    slider_tick_rate: float = 1.0
    # content
    timing_points: list = dataclasses.field(default_factory=list)
    _hit_objects: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)  # raw [Events] lines

    # -- queries -------------------------------------------------------------

    def hit_objects(self, stacking: bool = False, spinners: bool = True) -> list[HitObject]:
        """Hit objects in time order. `stacking` is accepted for API parity but
        only stacking=False is implemented (the only mode the pipeline uses,
        reference data_loading.py:129)."""
        if stacking:
            raise NotImplementedError("stacking adjustment is not implemented")
        objs = self._hit_objects
        if not spinners:
            objs = [ho for ho in objs if not isinstance(ho, Spinner)]
        return list(objs)

    def timing_point_at(self, time: timedelta) -> TimingPoint:
        """Latest timing point with offset <= time (inherited ones included);
        falls back to the first if none precede."""
        candidate = None
        for tp in self.timing_points:
            if tp.offset <= time:
                if candidate is None or tp.offset >= candidate.offset:
                    candidate = tp
        if candidate is None:
            candidate = self.timing_points[0]
        return candidate

    def uninherited_timing_point_at(self, time: timedelta) -> TimingPoint:
        candidate = None
        for tp in self.timing_points:
            if tp.parent is None and tp.offset <= time:
                candidate = tp
        if candidate is None:
            for tp in self.timing_points:
                if tp.parent is None:
                    return tp
        return candidate

    def cs(self) -> float:
        return self.circle_size

    # -- I/O -----------------------------------------------------------------

    @staticmethod
    def from_path(path) -> "Beatmap":
        from osu_diffusion_tpu_torch.beatmap.parser import parse_beatmap_file

        return parse_beatmap_file(path)

    def write_path(self, path) -> None:
        from osu_diffusion_tpu_torch.beatmap.writer import write_beatmap_file

        write_beatmap_file(self, path)
