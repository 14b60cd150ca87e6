"""Synthetic beatmaps for the benchmark's traffic: a copy of the
repository's corpus generator (tools/make_corpus.py), so that the yardstick
does not change when the tool does.

Maps are built from geometric pattern generators (streams on arcs, polygon
jumps, zigzags, mirrored pairs) with per-map BPM, spacing and pattern mix
drawn from a per-map PRNG seeded by (seed, index): circles, sliders with
linear, bezier and perfect curves and repeats, spinners, an inherited
timing point. `generate_map` is the tool's, unchanged; `write_corpus`
writes the tool's layout (TrackNNNNN/beatmaps/NNNNNN <name>.osu, the label
the file name's integer prefix).
"""
from __future__ import annotations

import math
import os
import random

HEADER = """osu file format v14

[General]
AudioFilename: audio.mp3
AudioLeadIn: 0
PreviewTime: -1
Countdown: 0
SampleSet: Normal
StackLeniency: 0.7
Mode: 0
LetterboxInBreaks: 0
WidescreenStoryboard: 1

[Metadata]
Title:synthetic {idx}
TitleUnicode:synthetic {idx}
Artist:corpus
ArtistUnicode:corpus
Creator:make_corpus
Version:v{idx}
Source:
Tags:
BeatmapID:{idx}
BeatmapSetID:{set_idx}

[Difficulty]
HPDrainRate:5
CircleSize:4
OverallDifficulty:8
ApproachRate:9
SliderMultiplier:{slider_mult}
SliderTickRate:1

[Events]
//Background and Video events

[TimingPoints]
0,{beat_len},4,1,0,100,1,0
{inherited}

[HitObjects]
"""


def _clip(x: float, lo: float, hi: float) -> float:
    return lo if x < lo else hi if x > hi else x


class _Cursor:
    """Walks the playfield emitting pattern positions."""

    def __init__(self, rng: random.Random):
        self.rng = rng
        self.x = rng.uniform(100, 412)
        self.y = rng.uniform(80, 304)

    def _place(self, x: float, y: float) -> tuple[int, int]:
        self.x = _clip(x, 0, 512)
        self.y = _clip(y, 0, 384)
        return int(round(self.x)), int(round(self.y))

    def stream_arc(self, n: int, spacing: float):
        """n positions along a circular arc, adjacent spacing ~= spacing px."""
        rng = self.rng
        radius = rng.uniform(60, 160)
        cx = _clip(self.x + rng.uniform(-radius, radius), 60, 452)
        cy = _clip(self.y + rng.uniform(-radius, radius), 60, 324)
        ang = math.atan2(self.y - cy, self.x - cx)
        step = (spacing / radius) * rng.choice([-1.0, 1.0])
        out = []
        for _ in range(n):
            ang += step
            out.append(self._place(cx + radius * math.cos(ang),
                                   cy + radius * math.sin(ang)))
        return out

    def jumps_polygon(self, n: int, spacing: float):
        """n positions hopping the vertices of a regular k-gon (k in 3..6),
        visiting order star-style for k=5 to mix symmetry classes."""
        rng = self.rng
        k = rng.randint(3, 6)
        radius = _clip(spacing / (2 * math.sin(math.pi / k)), 40, 170)
        cx = rng.uniform(radius + 10, 502 - radius)
        cy = rng.uniform(radius + 10, 374 - radius)
        phase = rng.uniform(0, 2 * math.pi)
        order = 2 if (k == 5 and rng.random() < 0.5) else 1
        out = []
        v = 0
        for _ in range(n):
            a = phase + 2 * math.pi * v / k
            out.append(self._place(cx + radius * math.cos(a),
                                   cy + radius * math.sin(a)))
            v = (v + order) % k
        return out

    def zigzag(self, n: int, spacing: float):
        """n positions alternating across a random axis (back-and-forth)."""
        rng = self.rng
        ang = rng.uniform(0, 2 * math.pi)
        dx, dy = math.cos(ang) * spacing, math.sin(ang) * spacing
        out = []
        sgn = 1.0
        for _ in range(n):
            nx, ny = self.x + sgn * dx, self.y + sgn * dy
            if not (0 <= nx <= 512 and 0 <= ny <= 384):
                # bounce off the edge by flipping the axis
                ang += math.pi / 2
                dx, dy = math.cos(ang) * spacing, math.sin(ang) * spacing
                nx, ny = self.x + sgn * dx, self.y + sgn * dy
            out.append(self._place(nx, ny))
            sgn = -sgn if rng.random() < 0.7 else sgn
        return out

    def mirrored(self, n: int, spacing: float):
        """Pairs mirrored across the playfield center (symmetry patterns)."""
        out = []
        for _ in range((n + 1) // 2):
            px = self.rng.uniform(40, 472)
            py = self.rng.uniform(30, 354)
            out.append(self._place(px, py))
            out.append(self._place(512 - px, 384 - py))
        return out[:n]


def generate_map(idx: int, set_idx: int, seed: int,
                 min_datapoints: int = 176) -> str:
    """One synthetic .osu file as text; label/BeatmapID = idx."""
    rng = random.Random((seed << 32) ^ idx)
    bpm = rng.uniform(120, 220)
    beat_len = 60000.0 / bpm
    slider_mult = round(rng.uniform(1.0, 2.2), 1)
    sv_pct = rng.randint(67, 150)  # one inherited point for parser variety

    cursor = _Cursor(rng)
    objs: list[str] = []
    t = 1000.0
    datapoints = 0
    combo_flag = 4  # new combo on the first object of each pattern

    while datapoints < min_datapoints:
        kind = rng.random()
        if kind < 0.35:
            gap = beat_len / 4  # stream
            pts = cursor.stream_arc(rng.randint(8, 20), rng.uniform(18, 32))
        elif kind < 0.60:
            gap = beat_len / 2  # jumps
            pts = cursor.jumps_polygon(rng.randint(4, 10), rng.uniform(90, 220))
        elif kind < 0.80:
            gap = beat_len / 2
            pts = cursor.zigzag(rng.randint(6, 12), rng.uniform(60, 140))
        else:
            gap = beat_len
            pts = cursor.mirrored(rng.randint(4, 8), 0.0)

        new = combo_flag
        for (x, y) in pts:
            r = rng.random()
            if r < 0.06 and datapoints > 4:
                # slider rows: head + interior anchors (n_ctrl-1; the final
                # control point is the curve tail) + last anchor + end
                n_ctrl = rng.randint(1, 2)
                curve = rng.choice("LBP") if n_ctrl == 1 else "B"
                span_px = rng.uniform(40, 120)
                ang = rng.uniform(0, 2 * math.pi)
                cps = []
                cx_, cy_ = float(x), float(y)
                for _ in range(n_ctrl):
                    cx_ = _clip(cx_ + math.cos(ang) * span_px / n_ctrl, 0, 512)
                    cy_ = _clip(cy_ + math.sin(ang) * span_px / n_ctrl, 0, 384)
                    cps.append(f"{int(round(cx_))}:{int(round(cy_))}")
                repeats = rng.choice([1, 1, 1, 2])
                length = round(span_px, 2)
                objs.append(
                    f"{x},{y},{int(round(t))},{2 | new},0,"
                    f"{curve}|{'|'.join(cps)},{repeats},{length}"
                )
                datapoints += 2 + n_ctrl
                # span duration per the .osu spec (velocity = mult*100*SV
                # px/beat, SV = sv_pct/100 from the inherited point);
                # advance past the tail so datapoint times stay monotone
                span_ms = length * beat_len / (slider_mult * sv_pct)
                t += max(gap, span_ms * repeats + gap / 2)
            elif r < 0.07:
                end = int(round(t + beat_len * rng.randint(2, 4)))
                objs.append(f"256,192,{int(round(t))},{8 | new},0,{end}")
                datapoints += 2
                t = end + beat_len
            else:
                objs.append(f"{x},{y},{int(round(t))},{1 | new},0")
                datapoints += 1
                t += gap
            new = 0

    inherited = f"{int(beat_len) + 1},{-10000.0 / sv_pct},4,1,0,100,0,0"
    head = HEADER.format(idx=idx, set_idx=set_idx, beat_len=round(beat_len, 6),
                         slider_mult=slider_mult, inherited=inherited)
    return head + "\n".join(objs) + "\n"


def write_corpus(out: str, num_files: int, maps_per_track: int, seed: int, min_datapoints: int) -> None:
    for i in range(num_files):
        set_idx = i // maps_per_track
        d = os.path.join(out, f"Track{set_idx:05d}", "beatmaps")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{i:06d} corpus - synthetic {i}.osu"), "w") as f:
            f.write(generate_map(i, set_idx, seed, min_datapoints))
