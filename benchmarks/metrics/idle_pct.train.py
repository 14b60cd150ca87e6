"""Share of the profiled slice (three steps, or one call of eight) in which
no device op ran."""


def read(record):
    tr = record.get("trace")
    if record.get("kind") != "train" or not tr or tr["window_s"] <= 0:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
