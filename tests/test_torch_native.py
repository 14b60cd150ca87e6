"""The port's native featurizer (osu_diffusion_tpu_torch/native, built with
g++ at first use from osu_diffusion_tpu_torch/csrc/osu_native.cpp) against
the port's Python featurizer and against the JAX package's library built
from native/osu_native.cpp. Skips only without g++ on PATH.

Tolerances: 2e-3 against the Python featurizer on the fixtures (the C++
computes the curves in double precision, the rows are float32; the bound of
tests/test_native.py), bit-equal against the JAX package's library (the
same code and flags)."""
import glob
import logging
import os
import random
import shutil
import threading

import numpy as np
import pytest

from test_parser_fuzz import MUTATORS
from torch_native_setup import ROOT, jax_native, port_native

FIXTURES = sorted(glob.glob(os.path.join(ROOT, "assets", "toy_datasets", "**", "*.osu"),
                            recursive=True))
KIMI = os.path.join(ROOT, "assets", "toy_datasets", "kimi_no_bouken.osu")


@pytest.fixture(scope="module")
def native():
    return port_native()


def _python_rows(path):
    from osu_diffusion_tpu_torch.beatmap.objects import Beatmap
    from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence

    return beatmap_to_sequence(Beatmap.from_path(path))


def test_native_matches_python_on_every_fixture(native):
    worst = 0.0
    for path in FIXTURES:
        got, want = native.featurize_file(path), _python_rows(path)
        assert got.dtype == np.float32 and got.shape == want.shape, path
        if got.size:
            worst = max(worst, float(np.abs(got - want).max()))
    assert len(FIXTURES) >= 60 and worst <= 2e-3, worst


def test_featurize_text_equals_featurize_file(native):
    with open(KIMI, encoding="utf-8") as f:
        text = f.read()
    np.testing.assert_array_equal(native.featurize_text(text), native.featurize_file(KIMI))


@pytest.mark.parametrize("text", ["osu file format v14\n", ""])
def test_empty_map_gives_no_rows(native, text):
    out = native.featurize_text(text)
    assert out.shape == (0, 19) and out.dtype == np.float32


def test_port_library_equals_the_jax_library(native, tmp_path_factory):
    jax_lib = jax_native(tmp_path_factory.mktemp("jax_native"))
    for path in FIXTURES:
        np.testing.assert_array_equal(native.featurize_file(path), jax_lib.featurize_file(path),
                                      err_msg=path)


def test_fuzzed_maps_get_the_same_decision_and_rows_both_ways(native):
    """tests/test_parser_fuzz.py's mutation operators, one seed: the native
    and the Python featurizer accept the same mutants and give the same
    rows where both accept (the fuzz test's rtol 1e-4, atol 2e-3)."""
    from osu_diffusion_tpu_torch.beatmap.parser import parse_beatmap
    from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence

    rng = random.Random(15)
    texts = []
    for path in FIXTURES:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        for _ in range(5):
            for _ in range(rng.randrange(1, 4)):
                text = rng.choice(MUTATORS)(text, rng)
            texts.append(text)
    both = 0
    for i, text in enumerate(texts):
        try:
            want = beatmap_to_sequence(parse_beatmap(text))
        except Exception:  # a clean rejection; the native side must reject too
            want = None
        try:
            got = native.featurize_text(text)
        except RuntimeError:
            got = None
        assert (got is None) == (want is None), (i, "python" if got is None else "native")
        if got is not None:
            both += 1
            assert got.shape == want.shape, i
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3, err_msg=str(i))
    assert len(texts) >= 300 and both > 100, (len(texts), both)


def test_two_threads_loading_at_once_get_one_library(native, monkeypatch):
    from osu_diffusion_tpu_torch.native import build

    monkeypatch.setattr(native, "_lib", None)
    builds = []
    real_build = build.build

    def counting_build(gxx):
        builds.append(gxx)
        return real_build(gxx)

    monkeypatch.setattr(build, "build", counting_build)
    barrier = threading.Barrier(2)
    got = []

    def load():
        barrier.wait()
        got.append(native.load_library())

    threads = [threading.Thread(target=load) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 2 and got[0] is not None and got[0] is got[1]
    assert len(builds) == 1


def test_library_name_follows_the_host(native, monkeypatch):
    """The library's name hashes what -march=native sets on the host, so a
    build directory copied to another host is not loaded there."""
    from osu_diffusion_tpu_torch.native import build

    gxx = shutil.which("g++")
    here, version = build.library_path(gxx)
    assert here == native.build_info["path"] and version.startswith("g++")
    real_run = build._run

    def other_host(cmd):
        out = real_run(cmd)
        return out.replace("-march=", "-march=  other-cpu ") if "--help=target" in cmd else out

    monkeypatch.setattr(build, "_run", other_host)
    assert build.library_path(gxx)[0] != here


def test_without_gxx_the_python_featurizer_runs_after_one_warning(monkeypatch, caplog):
    from osu_diffusion_tpu_torch import native as native_mod
    from osu_diffusion_tpu_torch.data import dataset
    from osu_diffusion_tpu_torch.native import build

    # caplog listens on the root logger; a trainer run earlier in this
    # process (utils/logger.create_logger) stops the package logger's
    # propagation, so let this test's warning reach the root whatever ran
    # before it
    monkeypatch.setattr(logging.getLogger("osu_diffusion_tpu_torch"), "propagate", True)
    monkeypatch.delenv("OSU_DIFFUSION_NO_NATIVE", raising=False)
    monkeypatch.setattr(native_mod, "_lib", None)
    monkeypatch.setattr(native_mod, "_no_compiler", False)
    monkeypatch.setattr(build, "compiler", lambda: None)
    with caplog.at_level(logging.WARNING):
        assert dataset.featurizer_name() == "python"
        seq, n = dataset.default_seq_func(KIMI)
        assert dataset.featurizer_name() == "python"
    np.testing.assert_array_equal(seq, _python_rows(KIMI))
    assert n == 757
    assert sum("no g++ on PATH" in r.getMessage() for r in caplog.records) == 1
    with pytest.raises(RuntimeError, match="not built"):
        native_mod.featurize_file(KIMI)


def test_a_failed_build_raises_and_the_loader_does_not_skip_over_it(native, monkeypatch, tmp_path):
    """A broken copy of the source must not hide behind the Python path, nor
    behind the loader's skipping of unparseable files."""
    from osu_diffusion_tpu_torch.data.dataset import BeatmapDatasetIterableFactory, get_data_loader
    from osu_diffusion_tpu_torch.native import build
    from osu_diffusion_tpu_torch.ops.cuda_build import BuildError

    broken = tmp_path / "osu_native.cpp"
    with open(build.SRC) as f:
        broken.write_text(f.read() + "\nint broken = ;\n")
    monkeypatch.setattr(build, "SRC", str(broken))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("OSU_DIFFUSION_NO_NATIVE", raising=False)
    with pytest.raises(BuildError, match="error"):
        native.load_library()
    track = tmp_path / "data" / "Track00000" / "beatmaps"
    track.mkdir(parents=True)
    shutil.copy(KIMI, track / "000001 kimi.osu")
    loader = get_data_loader(dataset_path=str(tmp_path / "data"), start=0, end=1,
                             iterable_factory=BeatmapDatasetIterableFactory(32, 16, seed=0),
                             batch_size=2, num_workers=0)
    with pytest.raises(BuildError):
        next(iter(loader))
