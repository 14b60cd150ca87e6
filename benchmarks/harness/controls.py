"""The controls and planted faults that set each limit's upper reading, at a
cell's own size, each judged by the same comparison with the cell's
limits as a run (`checks.compare`, `checks.keeps`).

A control is the computation put in the program's place at the precision
just below what the configuration states, or the program's own path at
that precision where it has one:

- `dit-b.sample` (f32 stream): the program's bf16 stream (`Sampler(
  compute_dtype=bfloat16)`), the same requests and noise, judged against
  the same reference.
- `dit-b.sample-int8` (int8 codes): the reference over int4 codes, judged
  against the reference over int8 codes.
- the train cells (bf16 stream): the reference with its stream and every
  product's operands in fp8 (e4m3), judged against the f32 reference.

A fault is planted in the program, on the card, where a replayed CUDA
graph can go wrong and the CPU (which runs the same code eagerly) cannot
show it:

- sample cells, `stale_x`: the model of a graphed chain sees at every
  step the x of the eager warm-up before its capture, while the step's
  update takes the live x.
- `dit-xl.train-fused`, `stale_inputs`: a replayed call does not copy its
  batches into the graph's inputs, so it trains again on the first call's.

Each reading runs the requests a check compares (the mix's longest map and
one drawn from the seed) or the train cell's first calls, one seed a
reading. Run on a card: `python -m benchmarks.harness.controls <cell>
[--sound | --fault] <seed>...` prints one JSON line a seed.
"""
from __future__ import annotations

import contextlib
import json
import sys

import numpy as np
import torch

from benchmarks.harness import checks


def judged(found: dict, limits: dict) -> dict:
    """The readings, and `correct` as a run with them would read it."""
    return {"correct": checks.keeps(checks.compare(found, limits)), "readings": found}


@contextlib.contextmanager
def stale_x():
    """The sampling chains' model fed, under capture, the x of the last
    eager call of its shape: no replay refreshes it."""
    from osu_diffusion_tpu_torch.models.dit import DiT

    forward = DiT.forward_with_cfg
    kept = {}

    def stale(self, x, *args, **kwargs):
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            x = kept[tuple(x.shape)]
        else:
            kept[tuple(x.shape)] = x.clone()
        return forward(self, x, *args, **kwargs)

    DiT.forward_with_cfg = stale
    try:
        yield
    finally:
        DiT.forward_with_cfg = forward


@contextlib.contextmanager
def stale_inputs():
    """A graphed train call that replays without copying its batches in."""
    from osu_diffusion_tpu_torch.train.train_step import TrainCall

    call = TrainCall.__call__

    def stale(self, batches):
        if self.graph is None:
            return call(self, batches)
        self.graph.replay()
        return {name: v.clone() for name, v in self.outputs.items()}

    TrainCall.__call__ = stale
    try:
        yield
    finally:
        TrainCall.__call__ = call


FAULTS = {"sample": stale_x, "train": stale_inputs}


def checked_requests(cell, seed: int, device, then):
    """`then(done)` of the requests a check compares, served by the cell's
    program, once its model is freed and while the maps it wrote are
    there."""
    from benchmarks.drivers import sample
    from benchmarks.harness.trace import Tracer

    client = sample.Client(cell, seed, device, Tracer())
    try:
        client.warm_up()
        longest = max(range(len(client.maps)), key=lambda k: client.maps[k][1])
        others = [k for k in range(len(client.maps)) if k != longest][:sample.CHECKED_REQUESTS - 1]
        done = [client.request(j) for j in [longest] + others]
        del client.sampler, client.model
        torch.cuda.empty_cache()
        return then(done)
    finally:
        client.close()


def found(cell, done: list[dict], seed: int, device) -> dict:
    """A sample run's check of `done`, as {number: reading}."""
    from benchmarks.drivers import sample

    return {c["name"]: c["value"] for c in sample.check(cell, done, seed, device)}


def sample_control(cell, seed: int, device) -> dict:
    """The control of a sample cell, judged."""
    from benchmarks.drivers import sample
    from benchmarks.harness.weights import derived_seed, make_state
    from benchmarks.reference.model import Precision

    traffic = cell.traffic
    bits = traffic["reference_bits"]
    if bits is None:  # the program's bf16 stream in the f32 stream's place
        low = type(cell)(**{**cell.__dict__, "traffic": dict(traffic, stream="bf16")})
        return judged(checked_requests(low, seed, device, lambda done: found(low, done, seed, device)),
                      cell.limits)

    def int4(done: list[dict]) -> float:
        state = make_state(cell.config, derived_seed(seed, 0), device)
        prec = Precision(**traffic["reference_precision"])
        gap = 0.0
        with torch.no_grad():
            for r in done:
                ref = sample.reference_chain(cell, state, r, seed, device, prec, bits)
                low = sample.reference_chain(cell, state, r, seed, device, prec, 4)
                gap = max(gap, float(np.abs(low - ref).max()))
        return gap

    return judged({"chain_gap": checked_requests(cell, seed, device, int4)}, cell.limits)


def train_control(cell, seed: int, device, which=("control", "half_batch")) -> dict:
    """{"control" | "half_batch": judged readings} of a train cell."""
    from benchmarks.drivers import train

    return {name: judged(found, cell.limits) for name, found in train.control(cell, seed, device, which).items()}


def fault(cell, seed: int, device) -> dict:
    """The cell's planted fault, judged: a sample cell's checked requests,
    or a train cell's first calls."""
    with FAULTS[cell.traffic["kind"]]():
        if cell.traffic["kind"] == "sample":
            got = checked_requests(cell, seed, device, lambda done: found(cell, done, seed, device))
        else:
            from benchmarks.drivers import train

            got = train.sound(cell, seed, device)
    return judged(got, cell.limits)


def main(argv) -> None:
    """`<cell> <seed>...` prints each seed's control; `--sound` a train
    cell's sound readings (its first calls and the reference, no window);
    `--fault` the cell's planted fault."""
    from benchmarks.harness.cell import find

    cell = find(argv[0])
    device = torch.device("cuda", 0)
    mode = argv[1] if argv[1].startswith("--") else "--control"
    for seed in (int(s) for s in argv[1 + (mode != "--control"):]):
        if mode == "--sound":
            from benchmarks.drivers import train

            reading = judged(train.sound(cell, seed, device), cell.limits)
        elif mode == "--fault":
            reading = fault(cell, seed, device)
        elif cell.traffic["kind"] == "sample":
            reading = sample_control(cell, seed, device)
        else:
            reading = train_control(cell, seed, device)
        print(json.dumps({"cell": cell.name, "seed": seed, mode[2:]: reading}, default=str), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
