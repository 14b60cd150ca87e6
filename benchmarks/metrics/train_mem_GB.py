"""The peak of the device memory the process reserved over the window, the
CUDA graphs' private pools included, in GB (train cells)."""


def read(record):
    if record.get("kind") != "train":
        return None
    return record["window_reserved_peak"] / 1e9
