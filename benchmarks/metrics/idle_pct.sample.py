"""Share of the profiled slice (two maps) in which no device op ran."""


def read(record):
    tr = record.get("trace")
    if record.get("kind") != "sample" or not tr or tr["window_s"] <= 0:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
