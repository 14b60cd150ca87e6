"""The port's training input path against the JAX package's: the streaming
loader on the native featurizer (bit-equal batches to JAX's loader on its
native featurizer; within 2e-3 of the port's Python featurizer), the cached
dataset (a cache written by either package gives both packages' cached
loaders the same batches in the same order), a make_corpus corpus, and
data_loading_torch.py. The native featurizer is built with g++ at first use
(tests skip only without g++ on PATH)."""
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_native_setup import ROOT, jax_native, port_native

sys.path.insert(0, os.path.join(ROOT, "tools"))

from make_corpus import write_corpus  # noqa: E402

NO_NATIVE = "OSU_DIFFUSION_NO_NATIVE"


@pytest.fixture(scope="module")
def natives(tmp_path_factory):
    """(port, jax) native featurizer modules, both loaded."""
    return port_native(), jax_native(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture(scope="module")
def tracks(tmp_path_factory):
    """Two Track folders: the stream fixtures and kimi_no_bouken (sliders,
    757 rows), file names prefixed with their labels."""
    root = tmp_path_factory.mktemp("tracks")
    src = os.path.join(ROOT, "assets", "toy_datasets", "stream")
    names = [os.path.join(src, n) for n in sorted(os.listdir(src))]
    names.append(os.path.join(ROOT, "assets", "toy_datasets", "kimi_no_bouken.osu"))
    for i, path in enumerate(names):
        track = root / f"Track{i % 2:05d}" / "beatmaps"
        track.mkdir(parents=True, exist_ok=True)
        shutil.copy(path, track / f"{i:06d} map.osu")
    return str(root)


def _batches(loader_fn, factory_cls, data):
    """Two epochs of the loader, one seed."""
    loader = loader_fn(dataset_path=data, start=0, end=2,
                       iterable_factory=factory_cls(16, 8, seed=5), cycle_length=3,
                       batch_size=8, num_workers=0, shuffle=True, drop_last=True, seed=5)
    return [b for _ in range(2) for b in loader]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for ((gw, gp), gy), ((ww, wp), wy) in zip(got, want):
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gy, wy)


def test_native_loader_gives_the_jax_native_loaders_batches(natives, tracks, monkeypatch):
    """The native twin of tests/test_torch_train.py's
    test_dataset_yields_the_jax_windows: one seed, two epochs, both packages
    on their native featurizers."""
    from osu_diffusion_tpu.data.dataset import BeatmapDatasetIterableFactory as JaxFactory
    from osu_diffusion_tpu.data.dataset import get_data_loader as jax_loader
    from osu_diffusion_tpu_torch.data.dataset import (
        BeatmapDatasetIterableFactory,
        featurizer_name,
        get_data_loader,
    )

    monkeypatch.delenv(NO_NATIVE, raising=False)
    assert featurizer_name() == "native" and natives[1].available()
    want = _batches(jax_loader, JaxFactory, tracks)
    got = _batches(get_data_loader, BeatmapDatasetIterableFactory, tracks)
    assert len(got) >= 8
    _assert_batches_equal(got, want)


def test_native_and_python_loaders_agree(natives, tracks, monkeypatch):
    from osu_diffusion_tpu_torch.data.dataset import BeatmapDatasetIterableFactory, get_data_loader

    monkeypatch.delenv(NO_NATIVE, raising=False)
    native = _batches(get_data_loader, BeatmapDatasetIterableFactory, tracks)
    monkeypatch.setenv(NO_NATIVE, "1")
    python = _batches(get_data_loader, BeatmapDatasetIterableFactory, tracks)
    assert len(native) == len(python) >= 8
    for ((nw, npv), ny), ((pw, ppv), py) in zip(native, python):
        np.testing.assert_allclose(nw, pw, rtol=0, atol=2e-3)
        np.testing.assert_allclose(npv, ppv, rtol=0, atol=2e-3)
        np.testing.assert_array_equal(ny, py)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_cache_gives_both_cached_loaders_the_same_batches(natives, tracks, tmp_path, writer,
                                                          monkeypatch):
    """A cache written by `writer`'s cache_dataset: both packages'
    get_cached_data_loader give the same batches in the same order over two
    shuffled passes with one seed, and the same len(), with and without
    drop_last."""
    from osu_diffusion_tpu.data import dataset as jax_ds
    from osu_diffusion_tpu_torch.data import dataset as port_ds

    monkeypatch.delenv(NO_NATIVE, raising=False)
    ds = {"jax": jax_ds, "port": port_ds}[writer]
    cache = str(tmp_path / "cache.pkl")
    ds.cache_dataset(cache, dataset_path=tracks, start=0, end=2,
                     iterable_factory=ds.BeatmapDatasetIterableFactory(16, 8, seed=3), cycle_length=2)
    for drop_last in (True, False):
        loaders = [m.get_cached_data_loader(cache, batch_size=8, shuffle=True, drop_last=drop_last,
                                            seed=7) for m in (jax_ds, port_ds)]
        want, got = ([b for _ in range(2) for b in loader] for loader in loaders)
        _assert_batches_equal(got, want)
        assert len(loaders[1]) == len(loaders[0]) == len(got) // 2
        with open(cache, "rb") as f:
            n = len(pickle.load(f))
        assert n % 8 != 0  # a partial last batch, dropped or not
        assert len(got) // 2 == (n // 8 if drop_last else n // 8 + 1)
        assert {b[1].shape[0] for b in got} == ({8} if drop_last else {8, n % 8})
        assert not all(np.array_equal(a[1], b[1]) for a, b in zip(got[:len(got) // 2],
                                                                 got[len(got) // 2:]))


def test_both_packages_write_the_same_cache(tracks, tmp_path, monkeypatch):
    from osu_diffusion_tpu.data import dataset as jax_ds
    from osu_diffusion_tpu_torch.data import dataset as port_ds

    monkeypatch.setenv(NO_NATIVE, "1")  # the Python featurizer on both sides
    caches = []
    for ds in (jax_ds, port_ds):
        path = str(tmp_path / f"{ds.__name__}.pkl")
        ds.cache_dataset(path, dataset_path=tracks, start=0, end=2,
                         iterable_factory=ds.BeatmapDatasetIterableFactory(16, 8, seed=3),
                         cycle_length=2)
        with open(path, "rb") as f:
            caches.append(pickle.load(f))
    want, got = caches
    assert len(got) == len(want) > 16
    for ((gw, gp), gy), ((ww, wp), wy) in zip(got, want):
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(gp, wp)
        assert gy == wy and isinstance(gy, int)


def test_loader_on_a_corpus_yields_the_file_name_labels(natives, tmp_path, monkeypatch):
    from osu_diffusion_tpu_torch.data.dataset import BeatmapDatasetIterableFactory, get_data_loader

    monkeypatch.delenv(NO_NATIVE, raising=False)
    out = str(tmp_path / "corpus")
    write_corpus(out, num_files=8, maps_per_track=4, seed=0, min_datapoints=176, progress_every=0)
    loader = get_data_loader(dataset_path=out, start=0, end=2,
                             iterable_factory=BeatmapDatasetIterableFactory(seq_len=128, stride=16),
                             cycle_length=2, batch_size=4, num_workers=2, shuffle=False,
                             drop_last=True)
    labels = set()
    for (win, prev), y in loader:
        assert win.shape == (4, 128, 19) and prev.shape == (4, 2) and y.dtype == np.int32
        labels.update(int(v) for v in y)
    assert labels == set(range(8))


def test_window_and_relative_time_matches_jax():
    import jax.numpy as jnp

    from osu_diffusion_tpu.data.process import window_and_relative_time as jax_window
    from osu_diffusion_tpu_torch.data.process import window_and_relative_time

    r = np.random.RandomState(0)
    seqs = (r.rand(3, 10, 2).astype(np.float32), (r.rand(3, 10) * 1e4).astype(np.float32),
            r.rand(3, 10, 144).astype(np.float32))
    want = jax_window(tuple(jnp.asarray(a) for a in seqs), 2, 7, 0.25)
    got = window_and_relative_time(tuple(torch.from_numpy(a) for a in seqs), 2, 7, 0.25)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_data_loading_torch_benchmark_runs_on_the_cpu(natives, tracks):
    env = {k: v for k, v in os.environ.items() if k != NO_NATIVE}
    res = subprocess.run([sys.executable, os.path.join(ROOT, "data_loading_torch.py"),
                          "--data-path", tracks, "--mode", "benchmark", "--batch-size", "8",
                          "--num-workers", "2", "--end", "2", "--seq-len", "16", "--stride", "8",
                          "--benchmark-batches", "5"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == "featurizer: native"
    assert lines[-1].startswith("5 batches / 40 windows in ") and "windows/sec" in lines[-1]
