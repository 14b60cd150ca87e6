"""Data points of the maps the window completed, over all the time of the
window (sample cells): every point has been through every denoise step
and the decode. The window ends when the last map started in it ends."""


def read(record):
    if record.get("kind") != "sample" or not record["requests"]:
        return None
    return sum(r["length"] for r in record["requests"]) / record["window_s"]
