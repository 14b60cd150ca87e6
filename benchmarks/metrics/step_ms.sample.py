"""Device milliseconds a denoise step: CUDA events around each map's chain,
all chains of the window over all their steps."""


def read(record):
    reqs = record.get("requests") if record.get("kind") == "sample" else None
    if not reqs or any(r["chain_s"] is None for r in reqs):
        return None
    return 1000 * sum(r["chain_s"] for r in reqs) / (len(reqs) * record["traffic"]["steps"])
