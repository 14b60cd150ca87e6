"""Host milliseconds an optimizer step spent waiting for the loader's next
batch (the benchmark's host clock around the loader), mean over the
window."""


def read(record):
    if record.get("kind") != "train" or not record["steps"]:
        return None
    return 1000 * record["data_wait_s"] / record["steps"]
