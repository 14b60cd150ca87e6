#!/usr/bin/env python
"""Inspect the training input path of the PyTorch + CUDA port: the loader of
osu_diffusion_tpu_torch/data/dataset.py over `TrackNNNNN/beatmaps/` in
[--start, --end), with the flags of data_loading.py.

    python data_loading_torch.py --data-path DS --mode benchmark --batch-size 256 --num-workers 4

`benchmark` prints the featurizer that runs (native or python), then
batches, windows and windows/s over --benchmark-batches batches.
`plotfirst` plots the position, time and context embeddings of the first
batch (needs matplotlib, imported only there).
"""
from __future__ import annotations

import argparse
import time


def main(args):
    from osu_diffusion_tpu_torch.data.dataset import (
        BeatmapDatasetIterableFactory,
        featurizer_name,
        get_data_loader,
    )

    print(f"featurizer: {featurizer_name()}", flush=True)
    loader = get_data_loader(
        dataset_path=args.data_path, start=args.start, end=args.end,
        iterable_factory=BeatmapDatasetIterableFactory(args.seq_len, args.stride),
        cycle_length=1, batch_size=args.batch_size, num_workers=args.num_workers,
        shuffle=False, drop_last=True,
    )

    if args.mode == "plotfirst":
        import matplotlib.pyplot as plt
        import torch

        from osu_diffusion_tpu_torch.data.process import split_and_process_sequence_no_augment
        from osu_diffusion_tpu_torch.ops.embeddings import (
            offset_sequence_embedding,
            position_sequence_embedding,
        )

        for (win, prev), y in loader:
            (x, o, c), _ = split_and_process_sequence_no_augment(torch.from_numpy(win),
                                                                 torch.from_numpy(prev))
            print(x.shape, o.shape, c.shape, y.shape)
            pos_emb = position_sequence_embedding(x * x.new_tensor([512.0, 384.0]), 128)
            off_emb = offset_sequence_embedding(o / 10, 128)
            print(pos_emb.shape)
            print(off_emb.shape)
            print(y)
            for j in range(min(args.batch_size, win.shape[0])):
                fig, axs = plt.subplots(3, figsize=(5, 20))
                axs[0].imshow(pos_emb[j].numpy())
                axs[1].imshow(off_emb[j].numpy())
                axs[2].imshow(c[j].numpy())
                print(y[j])
                plt.show()
            break
    elif args.mode == "benchmark":
        n_batches = n_windows = 0
        start = time.perf_counter()
        for (win, _prev), _y in loader:
            n_batches += 1
            n_windows += win.shape[0]
            if n_batches >= args.benchmark_batches:
                break
        elapsed = time.perf_counter() - start
        print(f"{n_batches} batches / {n_windows} windows in {elapsed:.2f}s "
              f"= {n_windows / elapsed:.1f} windows/sec")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-path", type=str, required=True)
    parser.add_argument("--mode", type=str, required=True, choices=["plotfirst", "benchmark"])
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--num-workers", type=int, default=0)
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--end", type=int, default=16291)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--stride", type=int, default=16)
    parser.add_argument("--benchmark-batches", type=int, default=7000)
    main(parser.parse_args())
