""".osu file writer (format v14).

Standalone replacement for slider's Beatmap.write_path (used by the reference at
sample.py:124). Emits every section the parser understands; round-trips through
osu_diffusion_tpu_torch.beatmap.parser.
"""
from __future__ import annotations

from datetime import timedelta
from pathlib import Path

from osu_diffusion_tpu_torch.beatmap.objects import Beatmap, Slider, Spinner


def _ms(t: timedelta) -> int:
    return int(round(t.total_seconds() * 1000.0))


def _num(x: float) -> str:
    """Render a float the way .osu files conventionally do (no trailing .0)."""
    if float(x) == int(x):
        return str(int(x))
    return repr(float(x))


def _timing_point_line(tp) -> str:
    uninherited = 1 if tp.parent is None else 0
    return ",".join(
        [
            str(_ms(tp.offset)),
            _num(tp.ms_per_beat),
            str(tp.meter),
            str(tp.sample_type),
            str(tp.sample_set),
            str(tp.volume),
            str(uninherited),
            str(1 if tp.kiai_mode else 0),
        ]
    )


def _type_bits(ho) -> int:
    if isinstance(ho, Slider):
        bits = 2
    elif isinstance(ho, Spinner):
        bits = 8
    else:
        bits = 1
    if ho.new_combo:
        bits |= 4
    bits |= (ho.combo_skip & 0b111) << 4
    return bits


def _hit_object_line(ho) -> str:
    x = str(int(round(ho.position.x)))
    y = str(int(round(ho.position.y)))
    t = str(_ms(ho.time))
    bits = str(_type_bits(ho))
    hs = str(ho.hitsound)
    if isinstance(ho, Spinner):
        return ",".join([x, y, t, bits, hs, str(_ms(ho.end_time)), "0:0:0:0:"])
    if isinstance(ho, Slider):
        pts = "|".join(
            f"{int(round(p.x))}:{int(round(p.y))}" for p in ho.curve.points[1:]
        )
        curve_spec = f"{ho.curve.kind}|{pts}" if pts else ho.curve.kind
        edge_sounds = "|".join(str(s) for s in ho.edge_sounds)
        edge_additions = "|".join(str(s) for s in ho.edge_additions)
        fields = [x, y, t, bits, hs, curve_spec, str(ho.repeat), _num(ho.length)]
        if edge_sounds or edge_additions:
            fields += [edge_sounds, edge_additions]
        fields.append("0:0:0:0:")
        return ",".join(fields)
    return ",".join([x, y, t, bits, hs, "0:0:0:0:"])


def render_beatmap(bm: Beatmap) -> str:
    lines = [f"osu file format v{bm.format_version}", ""]
    lines += [
        "[General]",
        f"AudioFilename: {bm.audio_filename}",
        f"AudioLeadIn: {bm.audio_lead_in}",
        f"PreviewTime: {bm.preview_time}",
        f"Countdown: {bm.countdown}",
        f"SampleSet: {bm.sample_set}",
        f"StackLeniency: {_num(bm.stack_leniency)}",
        f"Mode: {bm.mode}",
        f"LetterboxInBreaks: {1 if bm.letterbox_in_breaks else 0}",
        f"WidescreenStoryboard: {1 if bm.widescreen_storyboard else 0}",
        "",
        "[Editor]",
    ]
    if bm.bookmarks:
        lines.append("Bookmarks: " + ",".join(str(b) for b in bm.bookmarks))
    lines += [
        f"DistanceSpacing: {_num(bm.distance_spacing)}",
        f"BeatDivisor: {bm.beat_divisor}",
        f"GridSize: {bm.grid_size}",
        f"TimelineZoom: {_num(bm.timeline_zoom)}",
        "",
        "[Metadata]",
        f"Title:{bm.title}",
        f"TitleUnicode:{bm.title_unicode}",
        f"Artist:{bm.artist}",
        f"ArtistUnicode:{bm.artist_unicode}",
        f"Creator:{bm.creator}",
        f"Version:{bm.version}",
        f"Source:{bm.source}",
        "Tags:" + " ".join(bm.tags),
        f"BeatmapID:{bm.beatmap_id}",
        f"BeatmapSetID:{bm.beatmap_set_id}",
        "",
        "[Difficulty]",
        f"HPDrainRate:{_num(bm.hp_drain_rate)}",
        f"CircleSize:{_num(bm.circle_size)}",
        f"OverallDifficulty:{_num(bm.overall_difficulty)}",
        f"ApproachRate:{_num(bm.approach_rate)}",
        f"SliderMultiplier:{_num(bm.slider_multiplier)}",
        f"SliderTickRate:{_num(bm.slider_tick_rate)}",
        "",
        "[Events]",
    ]
    lines += list(bm.events)
    lines += ["", "[TimingPoints]"]
    for tp in sorted(bm.timing_points, key=lambda p: (p.offset, p.parent is not None)):
        lines.append(_timing_point_line(tp))
    lines += ["", "[HitObjects]"]
    for ho in bm._hit_objects:
        lines.append(_hit_object_line(ho))
    lines.append("")
    return "\n".join(lines)


def write_beatmap_file(bm: Beatmap, path) -> None:
    Path(path).write_text(render_beatmap(bm), encoding="utf-8")
