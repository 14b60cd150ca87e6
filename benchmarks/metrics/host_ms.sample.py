"""Host milliseconds a map outside its chain: parse, featurize, process,
CFG inputs before it; the copy back, decode and write after it (the
benchmark's host clock around its calls), mean over the window's maps."""


def read(record):
    reqs = record.get("requests") if record.get("kind") == "sample" else None
    if not reqs:
        return None
    return 1000 * sum(r["host_s"] for r in reqs) / len(reqs)
