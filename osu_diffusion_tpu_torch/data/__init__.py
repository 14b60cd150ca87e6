"""Host-side featurizer, sequence processing (torch) and the loaders.
Importing this builds nothing and touches no CUDA device."""
from osu_diffusion_tpu_torch.data.featurize import (
    FEATURE_SIZE,
    beatmap_to_sequence,
    create_datapoint,
    get_data,
    repeat_type,
)
from osu_diffusion_tpu_torch.data.process import (
    calc_distances,
    process_batch,
    split_and_process_sequence,
    split_and_process_sequence_no_augment,
    window_and_relative_time,
)
from osu_diffusion_tpu_torch.data.dataset import (
    BeatmapDataset,
    BeatmapDatasetIterable,
    BeatmapDatasetIterableFactory,
    CachedDataset,
    InterleavingBeatmapDatasetIterable,
    cache_dataset,
    get_beatmap_files,
    get_beatmap_idx,
    get_cached_data_loader,
    get_data_loader,
)

__all__ = [
    "FEATURE_SIZE",
    "beatmap_to_sequence",
    "create_datapoint",
    "get_data",
    "repeat_type",
    "calc_distances",
    "process_batch",
    "split_and_process_sequence",
    "split_and_process_sequence_no_augment",
    "window_and_relative_time",
    "BeatmapDataset",
    "BeatmapDatasetIterable",
    "BeatmapDatasetIterableFactory",
    "CachedDataset",
    "InterleavingBeatmapDatasetIterable",
    "cache_dataset",
    "get_beatmap_files",
    "get_beatmap_idx",
    "get_cached_data_loader",
    "get_data_loader",
]
