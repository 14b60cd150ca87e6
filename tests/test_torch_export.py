"""The port's beatmap export (`export/create_beatmap.py`) on generated
sequences that the reference's decode turns into a file its own parser
refuses, written and read back with the port's parser."""
import numpy as np

from osu_diffusion_tpu_torch.beatmap import Beatmap
from osu_diffusion_tpu_torch.beatmap.parser import MAX_TIME_MS
from osu_diffusion_tpu_torch.export import create_beatmap

FIXTURE = "assets/toy_datasets/kimi_no_bouken.osu"


def _row(x, y, time_ms, kind):
    """One (19,) sequence row: pixel position, time, datapoint type."""
    row = np.zeros(19, np.float32)
    row[:3] = x / 512, y / 384, time_ms
    row[3 + kind] = 1
    return row


def test_slider_ending_on_its_head_writes_a_readable_beatmap(tmp_path):
    """A slider head (type 4) at (100, 100), its span anchor (type 10) 100 px
    to the right and its end (type 12, one repeat) back on the head: the
    length fit's descent from t = 1 stops at t ~ 1e-14 instead of 0, so the
    fitted length is ~1e-12 px and -100 / SV a beat length of ~-8e13 ms,
    past the MAX_TIME_MS the parser accepts. The inherited timing point
    takes the zero-length fallback (-100) instead, and the file reads back
    with its one slider."""
    ref = Beatmap.from_path(FIXTURE)
    seq = np.stack([_row(100, 100, 1000, 4), _row(200, 100, 1100, 10), _row(100, 100, 1300, 12)])
    beatmap = create_beatmap(seq, ref, "slider back on its head")
    inherited = [tp.ms_per_beat for tp in beatmap.timing_points if tp.parent is not None]
    assert inherited == [-100]
    assert all(abs(tp.ms_per_beat) <= MAX_TIME_MS for tp in beatmap.timing_points)
    path = str(tmp_path / "slider.osu")
    beatmap.write_path(path)
    assert len(Beatmap.from_path(path).hit_objects()) == 1
