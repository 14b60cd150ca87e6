"""Streaming beatmap dataset: windowed iteration, interleaving and threaded
batch loading (port of osu_diffusion_tpu/data/dataset.py, host side).

- `BeatmapDatasetIterable` walks files and yields overlapping windows of
  `seq_len` with `stride`, from a random initial phase in [0, stride).
- `InterleavingBeatmapDatasetIterable` round-robins `cycle_length` disjoint
  file shards so one batch mixes many beatmaps; an exhausted shard is removed
  and the same index retried, so no shard is skipped.
- `DataLoader` splits the beatmap-set range over `num_workers` threads, each
  producing whole batches into a bounded queue.
- `cache_dataset` pickles every window of a range once, and
  `get_cached_data_loader` batches them with no featurizer in the loop.

An item is a RAW window, ((seq_len, 19) float32 rows, the predecessor's (2,)
coordinates) and the integer label; the distance embedding, flips and time
offset run in the train step (data/process.py, `process_batch`).

Randomness: `_mix_seed` and the `random.Random` streams are the JAX
package's, so for one seed this loader yields the same windows in the same
order as the JAX loader on the same featurizer. Files are featurized by the
native featurizer (osu_diffusion_tpu_torch/native, the C++ of
csrc/osu_native.cpp, built with g++ at first use; its calls release the GIL,
so the threads run in parallel), or by the Python one (data/featurize.py)
when OSU_DIFFUSION_NO_NATIVE is set or no g++ is on PATH. A failed build
raises. The cache's pickle layout is the JAX package's: a cache written by
either package loads in the other.
"""
from __future__ import annotations

import logging
import math
import os
import pickle
import queue
import random
import threading
from pathlib import Path, PurePosixPath, PureWindowsPath
from typing import Callable, Optional

import numpy as np

from osu_diffusion_tpu_torch.beatmap.objects import Beatmap
from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence
from osu_diffusion_tpu_torch.ops.cuda_build import BuildError

CENTER = np.array([256.0, 192.0], dtype=np.float32)


def _mix_seed(seed: int, epoch: int, sub: int = 0) -> int:
    """Deterministic per-(epoch, sub-iterator) seed: shuffle order and
    window phases re-roll every epoch, reproducibly for one base seed."""
    return ((seed * 1000003 + epoch) * 1000003 + sub) & 0xFFFFFFFFFFFF


def _native_featurizer():
    """The native featurizer module, or None where the Python one runs:
    OSU_DIFFUSION_NO_NATIVE set (read at each call), or no g++ on PATH
    (warned once). Builds the library at first use; a failed build raises."""
    if os.environ.get("OSU_DIFFUSION_NO_NATIVE"):
        return None
    from osu_diffusion_tpu_torch import native

    return native if native.available() else None


def featurizer_name() -> str:
    """'native' or 'python': what `default_seq_func` runs now."""
    return "python" if _native_featurizer() is None else "native"


def default_seq_func(beatmap_path: str):
    """(T, 19) raw featurization of a file; returns (seq, T)."""
    native = _native_featurizer()
    if native is not None:
        seq = native.featurize_file(beatmap_path)
    else:
        seq = beatmap_to_sequence(Beatmap.from_path(beatmap_path))
    return seq, seq.shape[0]


def default_win_func(seq: np.ndarray, s: int, e: int):
    """Raw window and the predecessor's coordinates (the playfield center
    before the first point)."""
    window = seq[s:e]
    prev_xy = seq[s - 1, :2] if s > 0 else CENTER
    return window, prev_xy.astype(np.float32)


class BeatmapDatasetIterable:
    """Per-shard window iterator. Yields (win_func(seq, s, s + seq_len),
    label), the label being the integer prefix of the file name (0 when it
    has none)."""

    __slots__ = (
        "beatmap_files", "seq_len", "stride", "index", "current_idx",
        "current_seq", "current_seq_len", "seq_index", "seq_func", "win_func",
        "rng",
    )

    def __init__(
        self,
        beatmap_files: list[str],
        seq_len: int,
        stride: int,
        seq_func: Callable = default_seq_func,
        win_func: Callable = default_win_func,
        rng: random.Random | None = None,
    ):
        self.beatmap_files = beatmap_files
        self.seq_len = seq_len
        self.stride = stride
        self.index = 0
        self.current_idx = 0
        self.current_seq = None
        self.current_seq_len = -1
        self.seq_index = 0
        self.seq_func = seq_func
        self.win_func = win_func
        self.rng = rng or random.Random()

    def __iter__(self):
        return self

    def __next__(self):
        while self.current_seq is None or self.seq_index + self.seq_len > self.current_seq_len:
            if self.index >= len(self.beatmap_files):
                raise StopIteration
            beatmap_path = self.beatmap_files[self.index]
            try:
                self.current_idx = int(os.path.basename(beatmap_path)[:6])
            except ValueError:
                self.current_idx = 0
            self.index += 1
            try:
                self.current_seq, self.current_seq_len = self.seq_func(str(beatmap_path))
            except BuildError:  # no file can be read: not a file's fault
                raise
            except Exception as e:
                # one malformed file must not stop a loader thread mid-run
                logging.getLogger(__name__).warning(
                    "skipping unparseable beatmap %s: %s", beatmap_path, e
                )
                self.current_seq = None
                self.current_seq_len = -1
                continue
            self.seq_index = self.rng.randint(0, self.stride - 1)
        window = self.win_func(self.current_seq, self.seq_index, self.seq_index + self.seq_len)
        self.seq_index += self.stride
        return window, self.current_idx


class InterleavingBeatmapDatasetIterable:
    """Round-robin over `cycle_length` disjoint file shards."""

    __slots__ = ("workers", "cycle_length", "index")

    def __init__(self, beatmap_files: list[str], iterable_factory: Callable, cycle_length: int):
        per_worker = int(math.ceil(len(beatmap_files) / float(cycle_length)))
        self.workers = [
            iterable_factory(beatmap_files[i * per_worker: min(len(beatmap_files), (i + 1) * per_worker)])
            for i in range(cycle_length)
        ]
        self.cycle_length = cycle_length
        self.index = 0

    def __iter__(self):
        return self

    def __next__(self):
        while self.workers:
            self.index = self.index % len(self.workers)
            try:
                item = next(self.workers[self.index])
                self.index += 1
                return item
            except StopIteration:
                del self.workers[self.index]
        raise StopIteration


class BeatmapDatasetIterableFactory:
    """Makes one `BeatmapDatasetIterable` per file shard. With a seed, each
    (epoch, sub-iterator) gets its own `random.Random` phase stream."""

    __slots__ = ("seq_len", "stride", "seq_func", "win_func", "seed")
    accepts_epoch = True

    def __init__(
        self,
        seq_len: int,
        stride: int,
        seq_func: Callable = default_seq_func,
        win_func: Callable = default_win_func,
        seed: int | None = None,
    ):
        self.seq_len = seq_len
        self.stride = stride
        self.seq_func = seq_func
        self.win_func = win_func
        self.seed = seed

    def __call__(self, beatmap_files: list[str], epoch: int = 0, sub: int = 0) -> BeatmapDatasetIterable:
        rng = random.Random(_mix_seed(self.seed, epoch, sub)) if self.seed is not None else random.Random()
        return BeatmapDatasetIterable(
            beatmap_files, seq_len=self.seq_len, stride=self.stride,
            seq_func=self.seq_func, win_func=self.win_func, rng=rng,
        )


class BeatmapDataset:
    """Iterable over `TrackNNNNN/beatmaps/*` for NNNNN in [start, end). Each
    pass advances the epoch, which re-rolls shuffle order and phases."""

    def __init__(
        self,
        dataset_path: str,
        start: int,
        end: int,
        iterable_factory: Callable,
        cycle_length: int = 1,
        shuffle: bool = False,
        beatmap_files: Optional[list[str]] = None,
        seed: int | None = None,
    ):
        self.dataset_path = dataset_path
        self.start = start
        self.end = end
        self.iterable_factory = iterable_factory
        self.cycle_length = cycle_length
        self.shuffle = shuffle
        self.beatmap_files = beatmap_files
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch counter (to replay a chosen epoch's stream); each
        pass of __iter__ otherwise advances it."""
        self.epoch = epoch

    def _get_beatmap_files(self) -> list[str]:
        if self.beatmap_files is not None:
            return list(self.beatmap_files)
        beatmap_files = []
        for i in range(self.start, self.end):
            track_dir = os.path.join(self.dataset_path, "Track" + str(i).zfill(5), "beatmaps")
            if not os.path.isdir(track_dir):
                continue
            for name in os.listdir(track_dir):
                beatmap_files.append(os.path.join(track_dir, name))
        return beatmap_files

    def __iter__(self):
        epoch = self.epoch
        self.epoch += 1
        beatmap_files = self._get_beatmap_files()
        if self.shuffle:
            rng = random.Random(_mix_seed(self.seed, epoch)) if self.seed is not None else random
            rng.shuffle(beatmap_files)

        if getattr(self.iterable_factory, "accepts_epoch", False):
            sub_counter = iter(range(1 << 30))

            def make_iterable(files):
                return self.iterable_factory(files, epoch=epoch, sub=next(sub_counter))
        else:
            make_iterable = self.iterable_factory

        if self.cycle_length > 1:
            return InterleavingBeatmapDatasetIterable(beatmap_files, make_iterable, self.cycle_length)
        return make_iterable(beatmap_files)


def get_beatmap_idx(name) -> dict[int, int]:
    """Beatmap id -> class label, from the pickle the repository ships
    (assets/beatmap_idx.pickle). Unpickle only files of this repository."""
    with Path(name).open("rb") as f:
        return pickle.load(f)


def get_beatmap_files(name: str, data_path: str) -> list[PurePosixPath]:
    """Beatmap paths from a pickled list of dataset-relative (Windows)
    paths, remapped under `data_path`."""
    with Path(name).open("rb") as f:
        relative = pickle.load(f)
    return [PurePosixPath(data_path, *PureWindowsPath(f).parts) for f in relative]


class CachedDataset:
    """The windows of a cache: a list of ((window, prev_xy), label)."""

    __slots__ = ("cached_data",)

    def __init__(self, cached_data):
        self.cached_data = cached_data

    def __getitem__(self, index):
        return self.cached_data[index]

    def __len__(self):
        return len(self.cached_data)

    def __iter__(self):
        return iter(self.cached_data)


def cache_dataset(
    out_path: str,
    dataset_path: str,
    start: int,
    end: int,
    iterable_factory: Callable,
    cycle_length: int = 1,
    beatmap_files: Optional[list[str]] = None,
) -> None:
    """Pickle every item of one unshuffled pass over the dataset to
    `out_path`, as a list of ((window, prev_xy), label)."""
    dataset = BeatmapDataset(
        dataset_path=dataset_path, start=start, end=end,
        iterable_factory=iterable_factory, cycle_length=cycle_length,
        shuffle=False, beatmap_files=beatmap_files,
    )
    cached = list(dataset)
    with open(out_path, "wb") as f:
        pickle.dump(cached, f)


class CachedDataLoader:
    """Batches of a `CachedDataset`, a fresh pass per iteration. With
    `shuffle` and a seed, pass p shuffles with
    random.Random((seed * 1_000_003 + p) & 0xFFFFFFFF), p counting the
    shuffled passes of this loader (the JAX package's order)."""

    def __init__(self, dataset: CachedDataset, batch_size: int, shuffle: bool, drop_last: bool,
                 seed: int | None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.passes = 0

    def __iter__(self):
        order = list(range(len(self.dataset)))
        if self.shuffle:
            if self.seed is not None:
                rng = random.Random((self.seed * 1_000_003 + self.passes) & 0xFFFFFFFF)
                self.passes += 1
            else:
                rng = random
            rng.shuffle(order)
        batch = []
        for i in order:
            batch.append(self.dataset[i])
            if len(batch) == self.batch_size:
                yield _collate(batch)
                batch = []
        if batch and not self.drop_last:
            yield _collate(batch)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)


def get_cached_data_loader(
    data_path: str,
    batch_size: int = 1,
    shuffle: bool = False,
    drop_last: bool = False,
    seed: int | None = None,
) -> CachedDataLoader:
    """A loader over the cache `cache_dataset` wrote (by either package).
    Unpickle only caches written by this repository's code."""
    with open(data_path, "rb") as f:
        cached = pickle.load(f)
    return CachedDataLoader(CachedDataset(cached), batch_size, shuffle, drop_last, seed)


def _collate(items):
    """[(window_tuple, label), ...] -> (stacked window columns, labels)."""
    wins, labels = zip(*items)
    if isinstance(wins[0], tuple):
        cols = tuple(np.stack(col, axis=0) for col in zip(*wins))
    else:
        cols = np.stack(wins, axis=0)
    return cols, np.asarray(labels, dtype=np.int32)


def _batch_iter(dataset: BeatmapDataset, batch_size: int, drop_last: bool):
    batch = []
    for item in dataset:
        batch.append(item)
        if len(batch) == batch_size:
            yield _collate(batch)
            batch = []
    if batch and not drop_last:
        yield _collate(batch)


class DataLoader:
    """Batched loader. The beatmap-set range [start, end) (or an explicit
    file list) is split contiguously over `num_workers` threads; each
    assembles whole batches and the caller drains a shared bounded queue.
    With num_workers 0 the batches are made in the caller's thread."""

    def __init__(
        self,
        dataset_path: str,
        start: int,
        end: int,
        iterable_factory: Callable,
        cycle_length: int = 1,
        batch_size: int = 1,
        num_workers: int = 0,
        shuffle: bool = False,
        drop_last: bool = False,
        beatmap_files: Optional[list[str]] = None,
        seed: int | None = None,
        prefetch: int = 4,
    ):
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.dataset = BeatmapDataset(
            dataset_path=dataset_path, start=start, end=end,
            iterable_factory=iterable_factory, cycle_length=cycle_length,
            shuffle=shuffle, beatmap_files=beatmap_files, seed=seed,
        )
        self._shards: list[BeatmapDataset] = []
        if self.num_workers > 0:
            # an explicit file list is sharded by file, a range by beatmap set
            if beatmap_files is not None:
                per_worker = int(math.ceil(len(beatmap_files) / float(self.num_workers)))
                file_shards = [beatmap_files[w * per_worker: (w + 1) * per_worker]
                               for w in range(self.num_workers)]
            else:
                per_worker = int(math.ceil((end - start) / float(self.num_workers)))
                file_shards = [None] * self.num_workers
            for w in range(self.num_workers):
                if beatmap_files is None:
                    ws = start + w * per_worker
                    we = min(ws + per_worker, end)
                else:
                    ws, we = start, end
                self._shards.append(BeatmapDataset(
                    dataset_path=dataset_path, start=ws, end=we,
                    iterable_factory=iterable_factory, cycle_length=cycle_length,
                    shuffle=shuffle, beatmap_files=file_shards[w],
                    seed=None if seed is None else seed + w,
                ))
        self.prefetch = prefetch

    def __iter__(self):
        if self.num_workers == 0:
            yield from _batch_iter(self.dataset, self.batch_size, self.drop_last)
            return
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch * self.num_workers)
        stop_ev = threading.Event()
        threads = []
        for shard in self._shards:
            t = threading.Thread(target=self._thread_main, args=(shard, out_q, stop_ev), daemon=True)
            t.start()
            threads.append(t)
        finished = 0
        try:
            while finished < len(threads):
                item = out_q.get()
                if item is None:
                    finished += 1
                    continue
                yield item
        finally:
            stop_ev.set()
            # drain until every producer has exited: a blocked producer
            # refills the bounded queue after a single drain
            for t in threads:
                while t.is_alive():
                    try:
                        out_q.get(timeout=0.05)
                    except queue.Empty:
                        pass
                t.join()

    def _thread_main(self, shard, out_q, stop_ev):
        try:
            for batch in _batch_iter(shard, self.batch_size, self.drop_last):
                if stop_ev.is_set():
                    break
                while not stop_ev.is_set():
                    try:
                        out_q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        finally:
            # the end-of-shard sentinel is delivered on normal completion and
            # never blocks after a stop (the consumer then drains by liveness)
            while not stop_ev.is_set():
                try:
                    out_q.put(None, timeout=0.1)
                    break
                except queue.Full:
                    continue


def get_data_loader(
    dataset_path: str,
    start: int,
    end: int,
    iterable_factory: Callable,
    cycle_length: int = 1,
    batch_size: int = 1,
    num_workers: int = 0,
    shuffle: bool = False,
    drop_last: bool = False,
    beatmap_files: Optional[list[str]] = None,
    seed: int | None = None,
) -> DataLoader:
    return DataLoader(
        dataset_path=dataset_path, start=start, end=end,
        iterable_factory=iterable_factory, cycle_length=cycle_length,
        batch_size=batch_size, num_workers=num_workers, shuffle=shuffle,
        drop_last=drop_last, beatmap_files=beatmap_files, seed=seed,
    )
