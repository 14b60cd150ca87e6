"""Decode a sampled coordinate sequence back into a playable beatmap (L6).

Behavioral parity with reference export/create_beatmap.py:22-212: a state
machine over the 16 datapoint types rebuilds circles/spinners/sliders, recovers
each slider's required length by fitting the generated end position onto the
reconstructed path, and emits an inherited timing point whose SV multiplier
makes the slider duration match the generated timing.

Input layout: (T, 19) time-major rows — [x_norm, y_norm, time_ms, 16 one-hots]
with coordinates normalized to the playfield (the sampler's output), vs. the
reference's channel-major (19, T).
"""
from __future__ import annotations

from datetime import timedelta

import numpy as np

from osu_diffusion_tpu_torch.beatmap.curves import SliderPath
from osu_diffusion_tpu_torch.beatmap.objects import (
    Beatmap,
    Circle,
    Curve,
    Position,
    Slider,
    Spinner,
    TimingPoint,
    make_slider,
)
from osu_diffusion_tpu_torch.beatmap.parser import MAX_TIME_MS


def position_to_progress(slider_path: SliderPath, pos: np.ndarray) -> float:
    """Find the path progress closest to `pos` by the reference's 100-step
    finite-difference descent from t=1 (export/create_beatmap.py:156-169)."""
    eps = 1e-4
    lr = 1
    t = 1.0
    for _ in range(100):
        grad = float(
            np.linalg.norm(slider_path.position_at(t) - pos)
            - np.linalg.norm(slider_path.position_at(t - eps) - pos)
        )
        t -= lr * grad
        if grad == 0 or t < 0 or t > 1:
            break
    return float(np.clip(t, 0, 1))


def _slider_path_to_curve(slider_path: SliderPath, req_length: float) -> Curve:
    points = [Position(float(p[0]), float(p[1])) for p in slider_path.control_points]
    return Curve.from_kind_and_points(slider_path.path_type[0], points, req_length)


def create_beatmap(seq, ref_beatmap: Beatmap, version: str) -> Beatmap:
    """(T, 19) sequence + reference beatmap -> new Beatmap difficulty.

    Parity: export/create_beatmap.py:22-147 (type switch, slider length fit,
    repeat recovery from duration/span, SV timing point emission).
    """
    seq = np.asarray(seq, dtype=np.float32)
    seq_len = seq.shape[0]
    hit_objects = []
    timing_points = [tp for tp in ref_beatmap.timing_points if tp.parent is None]
    curr_object = None
    curr_slider_path: list = []
    curr_slider_type = None
    # deliberately NOT reset per slider: the reference keeps one running
    # span_duration across the whole decode (create_beatmap.py:29,100), so a
    # slider ending in type 14/15 without its own type-10 anchor reuses the
    # previous slider's span — exact parity quirk (we only add the
    # span_duration > 0 guard against the reference's division by zero)
    span_duration = 0.0

    for j in range(seq_len):
        x = int(round(float(seq[j, 0] * 512)))
        y = int(round(float(seq[j, 1] * 384)))
        time = timedelta(seconds=float(seq[j, 2]) / 1000.0)
        type_index = int(np.argmax(seq[j, 3:]))
        pos = Position(x, y)

        if type_index == 0:
            hit_objects.append(Circle(pos, time, 0, new_combo=False))
        elif type_index == 1:
            hit_objects.append(Circle(pos, time, 0, new_combo=True))
        elif type_index == 2:
            curr_object = Spinner(pos, time, 0, new_combo=True, end_time=time)
        elif type_index == 3:
            if isinstance(curr_object, Spinner):
                curr_object.end_time = time
                hit_objects.append(curr_object)
        elif type_index in (4, 5):
            curr_object = make_slider(
                position=pos,
                time=time,
                end_time=time,
                curve=Curve.from_kind_and_points("B", [pos], 0),
                repeat=0,
                length=0,
                new_combo=(type_index == 5),
            )
            curr_slider_path = [list(pos)]
            curr_slider_type = "Bezier"
        elif isinstance(curr_object, Slider):
            if type_index == 6:
                curr_slider_path.append(list(pos))
            elif type_index == 7:
                curr_slider_path.append(list(pos))
                curr_slider_type = "PerfectCurve"
            elif type_index == 8:
                curr_slider_path.append(list(pos))
                curr_slider_type = "Catmull"
            elif type_index == 9:
                curr_slider_path.append(list(pos))
                curr_slider_path.append(list(pos))
            elif type_index == 10:
                curr_slider_path.append(list(pos))
                span_duration = (time - curr_object.time).total_seconds() * 1000.0
            else:  # 11..15: slider end -> finalize
                slider_path = SliderPath(
                    curr_slider_type, np.array(curr_slider_path, dtype=float)
                )
                req_length = slider_path.get_distance() * position_to_progress(
                    slider_path, np.array([pos.x, pos.y], dtype=float)
                )
                curr_object.curve = _slider_path_to_curve(slider_path, req_length)
                curr_object.length = req_length
                curr_object.end_time = time
                duration = (time - curr_object.time).total_seconds() * 1000.0
                # clamped to >= 1: degenerate generated timing can round to 0
                # repeats, which is not a writable slider (parser robustness
                # spec rejects slides < 1)
                curr_object.repeat = (
                    max(1, int(round(duration / span_duration)))
                    if type_index > 13 and span_duration > 0
                    else type_index - 10
                )
                curr_object.edge_sounds = [0] * curr_object.repeat
                curr_object.edge_additions = ["0:0"] * curr_object.repeat
                hit_objects.append(curr_object)

                # inherited timing point making the game's slider duration
                # match the generated one (parity :124-145)
                tp = ref_beatmap.timing_point_at(curr_object.time)
                parent = tp.parent if tp.parent is not None else tp
                ms_per_beat = (
                    tp.parent.ms_per_beat if tp.parent is not None else tp.ms_per_beat
                )
                global_sv = ref_beatmap.slider_multiplier
                new_sv_multiplier = (
                    req_length * ms_per_beat / (100 * global_sv * span_duration)
                    if span_duration > 0
                    else 0.0
                )
                # a fitted length so near 0 (a slider ending on its head: the
                # fit's descent can stop at t ~ 1e-14, not 0) that -100 / SV
                # would pass the beat length a parser accepts takes the
                # zero-length fallback, as a length of 0 does
                timing_points.append(
                    TimingPoint(
                        curr_object.time,
                        -100 / new_sv_multiplier if new_sv_multiplier > 100 / MAX_TIME_MS else -100,
                        tp.meter,
                        tp.sample_type,
                        tp.sample_set,
                        tp.volume,
                        parent,
                        tp.kiai_mode,
                    )
                )

    return new_difficulty(ref_beatmap, version, hit_objects, timing_points)


def new_difficulty(
    ref_beatmap: Beatmap, version: str, hit_objects: list, timing_points: list
) -> Beatmap:
    """Clone all metadata from the reference map, swap in the generated content.
    Parity: export/create_beatmap.py:172-212."""
    import dataclasses

    return dataclasses.replace(
        ref_beatmap,
        version=version,
        beatmap_id=0,
        timing_points=timing_points,
        _hit_objects=hit_objects,
    )


def plot_beatmap(ax, beatmap: Beatmap, time: float, window_size: float) -> list:
    """Render the sliders+circles inside a time window to matplotlib artists
    (for denoising-animation GIFs). Parity: export/create_beatmap.py:215-256."""
    from osu_diffusion_tpu_torch.beatmap.objects import Catmull, Linear, Perfect

    width = beatmap.cs() * 8
    hit_objects = beatmap.hit_objects(spinners=False)
    min_time = timedelta(seconds=(time - window_size) / 1000)
    max_time = timedelta(seconds=(time + window_size) / 1000)
    windowed = [ho for ho in hit_objects if min_time < ho.time < max_time]
    artists = []
    for hitobj in windowed:
        if not isinstance(hitobj, Slider):
            continue
        path_type = "Bezier"
        if isinstance(hitobj.curve, Perfect):
            path_type = "PerfectCurve"
        elif isinstance(hitobj.curve, Catmull):
            path_type = "Catmull"
        elif isinstance(hitobj.curve, Linear):
            path_type = "Linear"
        slider_path = SliderPath(
            path_type,
            np.array([[p.x, p.y] for p in hitobj.curve.points], dtype=float),
            hitobj.curve.req_length,
        )
        path: list = []
        slider_path.get_path_to_progress(path, 0, 1)
        p = np.vstack(path)
        artists.append(
            ax.plot(
                p[:, 0], p[:, 1],
                color="green", linewidth=width,
                solid_capstyle="round", solid_joinstyle="round",
            )[0]
        )
    p = np.array([[ho.position.x, ho.position.y] for ho in windowed]).reshape((-1, 2))
    artists.append(ax.scatter(p[:, 0], p[:, 1], s=width**2, c="Lime"))
    return artists
