"""Training log with the reference's format (port of
osu_diffusion_tpu/utils/logger.py): rank 0 logs, the other ranks are silent.

The line format is load-bearing: evals/plot_loss.py reads
"Train Loss: <x>, Train Steps/Sec: <y>" from these lines.
"""
from __future__ import annotations

import logging


def create_logger(logging_dir: str | None, rank: int = 0) -> logging.Logger:
    """Log to stderr and, with a directory, to `<dir>/log.txt`; on a rank
    other than 0, nowhere."""
    logger = logging.getLogger("osu_diffusion_tpu_torch")
    for handler in logger.handlers:  # an earlier run's log file in this process
        handler.close()
    logger.handlers.clear()
    logger.propagate = False
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("[\033[34m%(asctime)s\033[0m] %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
    if rank != 0:
        logger.addHandler(logging.NullHandler())
        return logger
    handlers = [logging.StreamHandler()]
    if logging_dir is not None:
        handlers.append(logging.FileHandler(f"{logging_dir}/log.txt"))
    for handler in handlers:
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger
