""".osu file parser.

Standalone implementation of the osu! beatmap text format (the subset the
pipeline needs — General/Editor/Metadata/Difficulty/Events/TimingPoints/
HitObjects; Colours and storyboard content are preserved as raw event lines or
skipped). Replaces the reference's external `slider` dependency
(reference requirements.txt:4).

Slider end times are derived the same way the game does: one span lasts
    length / (slider_multiplier * 100 * sv_multiplier) * beat_length  ms
with beat_length from the governing uninherited timing point and sv_multiplier
from the latest inherited point at the object's time.

Robustness spec (mirrored EXACTLY by the native parser, native/osu_native.cpp —
the two are interchangeable inside loader workers, so their accept/reject
decisions and outputs must agree; fuzz-tested in tests/test_parser_fuzz.py):
- fields that affect featurization (hit-object coordinates/times/types, curve
  points, slide counts, lengths, timing-point offsets/beat lengths,
  SliderMultiplier/SliderTickRate) are parsed STRICTLY: a malformed, non-finite
  or out-of-range value rejects the WHOLE file (ValueError here, nonzero status
  natively) — a bad line must fail loudly, never silently mis-featurize;
- cosmetic metadata (Metadata/General/Editor numbers, hitsounds, edge sounds,
  timing-point meter/volume fields) is parsed TOLERANTLY with defaults;
- bounds: |coordinate| <= 65536, |time| <= 1e9 ms (~11.6 days; also applied to
  computed slider end times), 0 <= slider length <= 1e7 px, slides >= 1;
- timing points are SORTED by offset at parse time (stable: equal offsets keep
  file order), matching the `slider` package — every layer (featurization,
  export, native) resolves the same governing point for out-of-order files.
"""
from __future__ import annotations

import math
import re
from datetime import timedelta
from pathlib import Path

from osu_diffusion_tpu_torch.beatmap.objects import (
    Beatmap,
    Circle,
    Curve,
    Position,
    Slider,
    Spinner,
    TimingPoint,
)

_TYPE_CIRCLE = 1
_TYPE_SLIDER = 2
_TYPE_NEW_COMBO = 4
_TYPE_SPINNER = 8
_COMBO_SKIP_SHIFT = 4


MAX_COORD = 65536.0
MAX_TIME_MS = 1e9
MAX_LENGTH = 1e7


def _parse_bool(v: str) -> bool:
    return v.strip() in ("1", "true", "True")


def _strict_token(s: str) -> str:
    """Shared numeric-token grammar with the native parser: ASCII only and no
    underscore separators — Python's float()/int() accept '2_56' and Unicode
    digits, std::stod/strtol do not, and the two featurizers must admit the
    same files byte-for-byte."""
    t = s.strip()
    if not t or not t.isascii() or "_" in t:
        raise ValueError(f"bad numeric token: {s!r}")
    return t


def _finite(s: str) -> float:
    """Strict float: full-token parse, finite value (load-bearing fields)."""
    v = float(_strict_token(s))
    if not math.isfinite(v):
        raise ValueError(f"non-finite value: {s!r}")
    return v


_INT_RE = re.compile(r"^[+-]?[0-9]+$")
_LONG_MAX = 2 ** 63 - 1
_LONG_MIN = -(2 ** 63)


def _strict_int(s: str) -> int:
    """Strict integer with the native grammar (sign + ASCII digits) and
    strtol's saturation at the int64 range (Python ints are unbounded)."""
    t = _strict_token(s)
    if not _INT_RE.match(t):
        raise ValueError(f"bad integer token: {s!r}")
    return min(max(int(t), _LONG_MIN), _LONG_MAX)


def _int32(v: int) -> int:
    """Two's-complement truncation to int32 — the shared, well-defined spec
    for the hit-object type field on both sides (native casts through
    uint32_t; relying on C++'s long->int narrowing would be UB/impl-defined)."""
    return ((v & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _coord(s: str) -> float:
    v = _finite(s)
    if abs(v) > MAX_COORD:
        raise ValueError(f"coordinate out of range: {s!r}")
    return v


def _time_ms_value(v: float) -> float:
    if not math.isfinite(v) or abs(v) > MAX_TIME_MS:
        raise ValueError(f"time out of range: {v!r}")
    return v


def _time_ms(s: str) -> float:
    return _time_ms_value(_finite(s))


def _num_or(s: str | None, default: float) -> float:
    """Tolerant float for cosmetic fields: junk falls back to the default
    (matches the native parser, which does not read these fields at all)."""
    if s is None:
        return default
    try:
        v = float(s)
    except ValueError:
        return default
    return v if math.isfinite(v) else default


def _int_or(s: str | None, default: int) -> int:
    return int(_num_or(s, default))


_SAMPLE_SETS = {"0": "None", "1": "Normal", "2": "Soft", "3": "Drum"}


def _split_sections(text: str) -> dict[str, list[str]]:
    sections: dict[str, list[str]] = {}
    current: list[str] | None = None
    for raw in text.splitlines():
        line = raw.rstrip("\r\n")
        stripped = line.strip()
        if stripped.startswith("[") and stripped.endswith("]"):
            current = sections.setdefault(stripped[1:-1], [])
            continue
        if current is None:
            continue
        current.append(line)
    return sections


def _kv(lines: list[str]) -> dict[str, str]:
    out = {}
    for line in lines:
        if not line.strip() or line.lstrip().startswith("//"):
            continue
        if ":" not in line:
            continue
        k, v = line.split(":", 1)
        out[k.strip()] = v.strip()
    return out


def _parse_timing_points(lines: list[str]) -> list[TimingPoint]:
    raw: list[tuple] = []
    for line in lines:
        line = line.strip()
        if not line or line.startswith("//"):
            continue
        parts = line.split(",")
        if len(parts) < 2:
            continue
        # offset/beat_length drive slider timing -> strict; the rest is
        # cosmetic -> tolerant (robustness spec, module docstring)
        offset = timedelta(milliseconds=_time_ms(parts[0]))
        beat_length = _finite(parts[1])
        if abs(beat_length) > MAX_TIME_MS:
            raise ValueError(f"beat length out of range: {parts[1]!r}")
        meter = _int_or(parts[2] if len(parts) > 2 else None, 4)
        sample_type = _int_or(parts[3] if len(parts) > 3 else None, 0)
        sample_set = _int_or(parts[4] if len(parts) > 4 else None, 0)
        volume = _int_or(parts[5] if len(parts) > 5 else None, 100)
        uninherited = _parse_bool(parts[6]) if len(parts) > 6 else beat_length > 0
        kiai = _parse_bool(parts[7]) if len(parts) > 7 else False
        raw.append((offset, beat_length, meter, sample_type, sample_set,
                    volume, uninherited, kiai))

    # sort-on-parse (stable: equal offsets keep file order), matching the
    # `slider` package the reference uses. All downstream layers — the
    # featurizer's last-in-list-order lookups, Beatmap.timing_point_at, the
    # native parser (lockstep std::stable_sort) — then agree on the governing
    # point even for files whose timing sections are out of order.
    raw.sort(key=lambda r: r[0])

    points: list[TimingPoint] = []
    last_uninherited: TimingPoint | None = None
    orphan_parent: TimingPoint | None = None
    for (offset, beat_length, meter, sample_type, sample_set, volume,
         uninherited, kiai) in raw:
        if uninherited and beat_length > 0:
            tp = TimingPoint(offset, beat_length, meter, sample_type, sample_set,
                             volume, None, kiai)
            last_uninherited = tp
        else:
            # an inherited point before any red line must NOT get parent=None
            # (that marks uninherited throughout the codebase); give it a
            # synthetic 500ms/beat parent — the same fallback the native
            # parser's BeatLengthAt uses for red-line-less files
            parent = last_uninherited
            if parent is None:
                if orphan_parent is None:
                    orphan_parent = TimingPoint(
                        timedelta(0), 500.0, 4, 0, 0, 100, None, False
                    )
                parent = orphan_parent
            tp = TimingPoint(offset, beat_length, meter, sample_type, sample_set,
                             volume, parent, kiai)
        points.append(tp)
    return points


def _parse_hit_objects(
    lines: list[str], beatmap: Beatmap
) -> list:
    objs = []
    for line in lines:
        line = line.strip()
        if not line or line.startswith("//"):
            continue
        parts = line.split(",")
        if len(parts) < 5:
            continue
        x, y = _coord(parts[0]), _coord(parts[1])
        time = timedelta(milliseconds=_time_ms(parts[2]))
        type_bits = _int32(_strict_int(parts[3]))
        hitsound = _int_or(parts[4], 0)  # cosmetic -> tolerant
        new_combo = bool(type_bits & _TYPE_NEW_COMBO)
        combo_skip = (type_bits >> _COMBO_SKIP_SHIFT) & 0b111
        pos = Position(x, y)

        if type_bits & _TYPE_CIRCLE:
            objs.append(Circle(pos, time, hitsound, new_combo, combo_skip))
        elif type_bits & _TYPE_SPINNER:
            end_time = (
                timedelta(milliseconds=_time_ms(parts[5])) if len(parts) > 5 else time
            )
            objs.append(Spinner(pos, time, hitsound, new_combo, combo_skip, end_time))
        elif type_bits & _TYPE_SLIDER:
            curve_spec = parts[5]
            slides = _strict_int(parts[6]) if len(parts) > 6 else 1
            if slides < 1:
                raise ValueError(f"slider slide count must be >= 1: {slides}")
            length = _finite(parts[7]) if len(parts) > 7 else 0.0
            if not 0.0 <= length <= MAX_LENGTH:
                raise ValueError(f"slider length out of range: {length!r}")
            # parts[8]/[9] are edgeSounds/edgeSets only when present; a short
            # line puts the hitSample (colon-separated) right after length.
            # Cosmetic -> tolerant (junk entries dropped).
            edge_sounds = []
            edge_additions = []
            if len(parts) > 8 and parts[8] and ":" not in parts[8]:
                try:
                    edge_sounds = [int(s) for s in parts[8].split("|")]
                except ValueError:
                    edge_sounds = []
                if len(parts) > 9 and parts[9]:
                    edge_additions = parts[9].split("|")

            kind, *pt_strs = curve_spec.split("|")
            # the head position is the first control point (the file omits it)
            points = [pos]
            for s in pt_strs:
                if not s:
                    continue
                xy = s.split(":")
                if len(xy) != 2:
                    raise ValueError(f"malformed curve point: {s!r}")
                points.append(Position(_coord(xy[0]), _coord(xy[1])))
            curve = Curve.from_kind_and_points(kind, points, length)

            red = _uninherited_at(beatmap.timing_points, time)
            green = _timing_at(beatmap.timing_points, time)
            ms_per_beat = red.ms_per_beat if red is not None else 500.0
            sv_mult = green.sv_multiplier if green is not None else 1.0
            velocity = beatmap.slider_multiplier * 100.0 * sv_mult  # px per beat
            span_ms = length / velocity * ms_per_beat if velocity > 0 else 0.0
            num_beats = length / velocity * slides if velocity > 0 else 0.0
            end_ms = _time_ms_value(
                time.total_seconds() * 1000.0 + span_ms * slides
            )
            end_time = timedelta(milliseconds=end_ms)
            objs.append(
                Slider(
                    position=pos,
                    time=time,
                    hitsound=hitsound,
                    new_combo=new_combo,
                    combo_skip=combo_skip,
                    end_time=end_time,
                    curve=curve,
                    repeat=slides,
                    length=length,
                    ticks=0,
                    num_beats=num_beats,
                    tick_rate=beatmap.slider_tick_rate,
                    ms_per_beat=ms_per_beat,
                    edge_sounds=edge_sounds,
                    edge_additions=edge_additions,
                ),
            )
    return objs


# Timing lookups are last-in-list-order among points with offset <= t. Since
# timing points are sorted by offset at parse time (in BOTH parsers — see
# _parse_timing_points and osu_native.cpp), this is identical to
# Beatmap.timing_point_at's max-offset rule on every beatmap, including
# files whose timing sections were out of order on disk.
def _uninherited_at(points: list[TimingPoint], time: timedelta) -> TimingPoint | None:
    candidate = None
    for tp in points:
        if tp.parent is None and tp.offset <= time:
            candidate = tp
    if candidate is None:
        for tp in points:
            if tp.parent is None:
                return tp
    return candidate


def _timing_at(points: list[TimingPoint], time: timedelta) -> TimingPoint | None:
    candidate = None
    for tp in points:
        if tp.offset <= time:
            candidate = tp
    if candidate is None and points:
        candidate = points[0]
    return candidate


def parse_beatmap_file(path) -> Beatmap:
    text = Path(path).read_text(encoding="utf-8-sig", errors="replace")
    return parse_beatmap(text)


def parse_beatmap(text: str) -> Beatmap:
    # BOM-only text has no lines after the lstrip; treat it like empty input
    # (the native parser accepts it with zero rows) instead of IndexError
    lines = text.lstrip("﻿").splitlines()
    first_line = lines[0] if lines else ""
    format_version = 14
    if "osu file format v" in first_line:
        try:
            format_version = int(first_line.split("osu file format v")[1].strip())
        except ValueError:
            pass

    sections = _split_sections(text)
    general = _kv(sections.get("General", []))
    editor = _kv(sections.get("Editor", []))
    meta = _kv(sections.get("Metadata", []))
    diff = _kv(sections.get("Difficulty", []))

    def _bookmarks(raw: str) -> list[int]:
        out = []
        for b in raw.split(","):
            if b.strip():
                try:
                    out.append(int(b))
                except ValueError:
                    pass
        return out

    # all numeric header fields are cosmetic -> tolerant with defaults
    # (robustness spec, module docstring), EXCEPT SliderMultiplier and
    # SliderTickRate below, which drive slider timing
    bm = Beatmap(
        format_version=format_version,
        audio_filename=general.get("AudioFilename", "audio.mp3"),
        audio_lead_in=_int_or(general.get("AudioLeadIn"), 0),
        preview_time=_int_or(general.get("PreviewTime"), -1),
        countdown=_int_or(general.get("Countdown"), 0),
        sample_set=general.get("SampleSet", "Normal"),
        stack_leniency=_num_or(general.get("StackLeniency"), 0.7),
        mode=_int_or(general.get("Mode"), 0),
        letterbox_in_breaks=_parse_bool(general.get("LetterboxInBreaks", "0")),
        widescreen_storyboard=_parse_bool(general.get("WidescreenStoryboard", "0")),
        bookmarks=_bookmarks(editor.get("Bookmarks", "")),
        distance_spacing=_num_or(editor.get("DistanceSpacing"), 1.0),
        beat_divisor=_int_or(editor.get("BeatDivisor"), 4),
        grid_size=_int_or(editor.get("GridSize"), 4),
        timeline_zoom=_num_or(editor.get("TimelineZoom"), 1.0),
        title=meta.get("Title", ""),
        title_unicode=meta.get("TitleUnicode", meta.get("Title", "")),
        artist=meta.get("Artist", ""),
        artist_unicode=meta.get("ArtistUnicode", meta.get("Artist", "")),
        creator=meta.get("Creator", ""),
        version=meta.get("Version", ""),
        source=meta.get("Source", ""),
        tags=meta.get("Tags", "").split() if meta.get("Tags") else [],
        beatmap_id=_int_or(meta.get("BeatmapID"), 0),
        beatmap_set_id=_int_or(meta.get("BeatmapSetID"), -1),
        hp_drain_rate=_num_or(diff.get("HPDrainRate"), 5.0),
        circle_size=_num_or(diff.get("CircleSize"), 5.0),
        overall_difficulty=_num_or(diff.get("OverallDifficulty"), 5.0),
        approach_rate=_num_or(
            diff.get("ApproachRate"), _num_or(diff.get("OverallDifficulty"), 5.0)
        ),
        # strict: these scale every slider's duration (robustness spec)
        slider_multiplier=(
            _finite(diff["SliderMultiplier"]) if "SliderMultiplier" in diff else 1.4
        ),
        slider_tick_rate=(
            _finite(diff["SliderTickRate"]) if "SliderTickRate" in diff else 1.0
        ),
        events=[l for l in sections.get("Events", [])],
    )
    bm.timing_points = _parse_timing_points(sections.get("TimingPoints", []))
    bm._hit_objects = _parse_hit_objects(sections.get("HitObjects", []), bm)
    return bm
