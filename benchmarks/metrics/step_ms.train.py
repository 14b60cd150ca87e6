"""Device milliseconds an optimizer step: CUDA events around each step or
call, all of the window's over its optimizer steps."""


def read(record):
    if record.get("kind") != "train" or not record["steps"] or record.get("device_s") is None:
        return None
    return 1000 * record["device_s"] / record["steps"]
