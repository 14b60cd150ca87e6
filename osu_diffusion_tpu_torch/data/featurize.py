"""Beatmap -> datapoint-sequence featurizer (host side, numpy).

A copy of osu_diffusion_tpu/data/featurize.py: importing that module runs
osu_diffusion_tpu/data/__init__.py, which imports jax. The output is the same
float32 (T, 19) array, time-major, channels last.

Feature layout per datapoint (parity data_loading.py:32-39):
    [0] x  [1] y  [2] time in ms  [3..18] one-hot of 16 datapoint types

Datapoint types (parity data_loading.py:65-124):
    0 circle, 1 circle+new-combo, 2 spinner start, 3 spinner end,
    4 slider head, 5 slider head+new-combo, 6 bezier anchor, 7 perfect anchor,
    8 catmull anchor, 9 red anchor (duplicated bezier anchor / linear),
    10 last anchor, 11..15 slider end with repeat class repeat_type(r).
"""
from __future__ import annotations

from datetime import timedelta

import numpy as np

from osu_diffusion_tpu_torch.beatmap.objects import (
    Beatmap,
    Catmull,
    Linear,
    MultiBezier,
    Perfect,
    Position,
    Slider,
    Spinner,
)

from osu_diffusion_tpu_torch import FEATURE_SIZE


def create_datapoint(time: timedelta, pos: Position, datatype: int) -> np.ndarray:
    features = np.zeros(FEATURE_SIZE, dtype=np.float32)
    features[0] = pos.x
    features[1] = pos.y
    features[2] = time.total_seconds() * 1000.0
    features[datatype + 3] = 1.0
    return features


def repeat_type(repeat: int) -> int:
    """Classify slider repeat counts. Parity: data_loading.py:42-48."""
    if repeat < 4:
        return repeat - 1
    elif repeat % 2 == 0:
        return 3
    else:
        return 4


def _append_control_points(
    datapoints: list[np.ndarray], slider: Slider, datatype: int, duration: timedelta
) -> None:
    """Interior control points, linearly timed across the first span.
    Parity: data_loading.py:51-62."""
    points = slider.curve.points
    n = len(points)
    for i in range(1, n - 1):
        time = slider.time + (i / (n - 1)) * duration
        datapoints.append(create_datapoint(time, points[i], datatype))


def get_data(hitobj) -> np.ndarray:
    """One hit object -> (k, 19) datapoint rows. Parity: data_loading.py:65-124."""
    if isinstance(hitobj, Slider) and len(hitobj.curve.points) < 100:
        datapoints = [
            create_datapoint(
                hitobj.time, hitobj.position, 5 if hitobj.new_combo else 4
            )
        ]
        assert hitobj.repeat >= 1
        duration: timedelta = (hitobj.end_time - hitobj.time) / hitobj.repeat

        curve = hitobj.curve
        if isinstance(curve, Linear):
            _append_control_points(datapoints, hitobj, 9, duration)
        elif isinstance(curve, Catmull):
            _append_control_points(datapoints, hitobj, 8, duration)
        elif isinstance(curve, Perfect):
            _append_control_points(datapoints, hitobj, 7, duration)
        elif isinstance(curve, MultiBezier):
            points = curve.points
            n = len(points)
            for i in range(1, n - 1):
                time = hitobj.time + (i / (n - 1)) * duration
                pos = points[i]
                if pos == points[i + 1]:
                    datapoints.append(create_datapoint(time, pos, 9))  # red anchor
                elif pos != points[i - 1]:
                    datapoints.append(create_datapoint(time, pos, 6))

        datapoints.append(
            create_datapoint(hitobj.time + duration, curve.points[-1], 10)
        )
        slider_end_pos = curve(1)
        datapoints.append(
            create_datapoint(
                hitobj.end_time, slider_end_pos, 11 + repeat_type(hitobj.repeat)
            )
        )
        return np.stack(datapoints, axis=0)

    if isinstance(hitobj, Spinner):
        return np.stack(
            (
                create_datapoint(hitobj.time, hitobj.position, 2),
                create_datapoint(hitobj.end_time, hitobj.position, 3),
            ),
            axis=0,
        )

    return create_datapoint(
        hitobj.time, hitobj.position, 1 if hitobj.new_combo else 0
    )[None, :]


def beatmap_to_sequence(beatmap: Beatmap) -> np.ndarray:
    """Full beatmap -> (T, 19) float32. Parity: data_loading.py:127-135 (which
    returns the transposed (19, T))."""
    hit_objects = beatmap.hit_objects(stacking=False)
    chunks = [get_data(ho) for ho in hit_objects]
    if not chunks:
        return np.zeros((0, FEATURE_SIZE), dtype=np.float32)
    return np.concatenate(chunks, axis=0).astype(np.float32)
