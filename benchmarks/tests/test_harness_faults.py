"""A run driven past the harness's look for a chip, on the CPU at a tiny
size, with the timed path broken underneath: `correct` comes out false for
each fault a cell can have (a step that returns its state unchanged; half
of the batch left out, the mean taken over the rest; an answer altered
where it is produced; a train call on the batches of the call before). No
cell has an exchange between chips to leave out. A sound sampling run at
that size comes out correct."""
import numpy as np
import pytest
import torch

import benchmarks.run as run
from benchmarks.harness.cell import find

SEED = 2 ** 31 + 17


def tiny(name):
    cell = find(name)
    cell.config.update(hidden_size=64, depth=2, num_heads=2, num_classes=50)
    if cell.traffic["kind"] == "sample":
        cell.traffic.update(lengths=[40, 130, 70], steps=20)
    else:
        cell.traffic.update(batch=8, loader_threads=2, reference_rows=4,
                            corpus={"maps": 8, "maps_per_track": 4, "min_datapoints": 300},
                            steps_per_call=min(cell.traffic["steps_per_call"], 2))
    return cell


def correct(cell, seconds=1.0):
    return run.run_cell(cell, SEED, seconds, False, torch.device("cpu"))[0]["correct"]


@pytest.mark.parametrize("name", ["dit-b.sample", "dit-b.sample-int8"])
def test_sound_sampling_run_is_correct(name):
    assert correct(tiny(name))


def test_sampling_step_that_keeps_its_state(monkeypatch):
    from osu_diffusion_tpu_torch.diffusion.process import StepProgram

    monkeypatch.setattr(StepProgram, "__call__", lambda self: None)
    assert not correct(tiny("dit-b.sample"))


@pytest.mark.parametrize("name", ["dit-b.sample", "dit-b.sample-int8"])
def test_sampling_answer_altered_in_the_chain(monkeypatch, name):
    from osu_diffusion_tpu_torch.sampling import Sampler

    call = Sampler.__call__
    monkeypatch.setattr(Sampler, "__call__", lambda self, *a, **k: call(self, *a, **k) + 0.25)
    assert not correct(tiny(name))


def test_sampling_answer_altered_in_the_decode(monkeypatch):
    import osu_diffusion_tpu_torch.export as export

    decode = export.create_beatmap

    def shifted(seq, *a, **k):
        seq = np.array(seq)
        seq[0, 0] += 1.0 / 512  # the first point one pixel to the right
        return decode(seq, *a, **k)

    monkeypatch.setattr(export, "create_beatmap", shifted)
    assert not correct(tiny("dit-b.sample"))


@pytest.mark.parametrize("name", ["dit-xl.train", "dit-xl.train-fused"])
def test_train_step_that_keeps_its_state(monkeypatch, name):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    assert not correct(tiny(name))


@pytest.mark.parametrize("name", ["dit-xl.train", "dit-xl.train-fused"])
def test_train_step_over_half_the_batch(monkeypatch, name):
    import osu_diffusion_tpu_torch.train.train_step as ts

    terms = ts.loss_terms

    def half(*a, **k):
        out = terms(*a, **k)
        return {key: v[: v.shape[0] // 2] for key, v in out.items()}

    monkeypatch.setattr(ts, "loss_terms", half)
    assert not correct(tiny(name))


def test_train_call_after_the_first_on_stale_batches(monkeypatch):
    # on the CPU a call runs its steps eagerly: the second call trains on
    # the first call's batches, as a replay that skips its input copy would
    from osu_diffusion_tpu_torch.train.train_step import TrainCall

    call, first = TrainCall.__call__, []

    def stale(self, batches):
        first.append(batches)
        return call(self, first[0])

    monkeypatch.setattr(TrainCall, "__call__", stale)
    assert not correct(tiny("dit-xl.train-fused"))


def test_train_loss_altered_where_produced(monkeypatch):
    import osu_diffusion_tpu_torch.train.train_step as ts

    terms = ts.loss_terms

    def scaled(*a, **k):
        out = terms(*a, **k)
        return {key: v * 1.05 for key, v in out.items()}

    monkeypatch.setattr(ts, "loss_terms", scaled)
    assert not correct(tiny("dit-xl.train"))
