"""Loss-curve overlay from training log files (port of
osu_diffusion_tpu/evals/plot_loss.py).

Parity with reference testing/plot_loss.py: scrapes "Train Loss: " values (the
port's trainer writes the reference's line, train/trainer.py) and overlays
them on a log-scale plot (matplotlib, imported by `main` only).
"""
from __future__ import annotations

import os


def parse_losses(log_path: str) -> list[float]:
    """Fixed-offset scrape, parity plot_loss.py:30-37."""
    losses = []
    with open(log_path) as f:
        for line in f:
            pos = line.find("Train Loss: ")
            if pos < 0:
                continue
            losses.append(float(line[pos + 12 : pos + 12 + 6]))
    return losses


def main(argv=None):
    import argparse

    import matplotlib.pyplot as plt

    parser = argparse.ArgumentParser()
    parser.add_argument("logs", nargs="+",
                        help="log.txt paths, optionally PATH:X_OFFSET")
    parser.add_argument("--out", default=None, help="save figure instead of showing")
    args = parser.parse_args(argv)

    for spec in args.logs:
        if ":" in spec and spec.rsplit(":", 1)[1].isdigit():
            path, off = spec.rsplit(":", 1)
            x_offset = int(off)
        else:
            path, x_offset = spec, 0
        losses = parse_losses(path)
        x = range(x_offset, x_offset + len(losses))
        plt.plot(x, losses, label=os.path.basename(os.path.dirname(path)))

    plt.yscale("log")
    plt.legend()
    if args.out:
        plt.savefig(args.out)
        print(f"saved {args.out}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
