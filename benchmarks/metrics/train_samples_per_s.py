"""128-point windows trained on over all the time of the window, the loader
included (train cells)."""


def read(record):
    if record.get("kind") != "train" or not record["steps"]:
        return None
    return record["steps"] * record["batch"] / record["window_s"]
