"""Traffic of kind "train": the train CLI's loop (train/trainer.py) at its
defaults, or with the mix's backward and steps a call.

Set-up writes a corpus under TMPDIR from the seed (the repository's
generator, TrackNNNNN/beatmaps layout), builds the model on the card with
the seed's weights, its EMA, AdamW and the loader (threads over the track
folders, the native featurizer, shuffled from the seed), and a CUDA
generator seeded from the seed for the step's draws (flips, offsets,
timesteps, noise, label drops), as the trainer has one. It then drives
the mix's `first_calls` through the window's own call and feed, reading
the state the comparison needs: single `train_step`s, or `TrainCall`s of
`steps_per_call` steps, the first of which runs its steps eagerly as the
graph's warm-up and captures it, and the second of which replays the
graph as every call of the window does. The window continues the same
object: batches from the loader to the card, a step or a call each, no
sync until the window's end, until --seconds have passed. No checkpoint
is saved.

After the window: the plain reference follows every step of the first
calls from the same weights, batches and draws (its own generator at the
program's generator's first state), in f32, and compares: the L1 term of
the first step or call (the loss without its VLB term, whose decoder
likelihood at t ~ 0 makes one sample's term swing with the last bits of
its prediction: the whole loss read 10x apart between seeds); the worst
leaf's first gradient (from AdamW's first moment after one step) or,
after a call, AdamW's second moment; the worst leaf's change after the
first steps or call, and the EMA's; and over the replayed call its own
numbers, the direction of the weights' change among them.
"""
from __future__ import annotations

import gc
import shutil
import tempfile
import time

import torch

from benchmarks.harness import checks, maps
from benchmarks.harness.checks import leaf_norms as norms
from benchmarks.harness.trace import Tracer
from benchmarks.harness.weights import derived_seed, make_state, program_model
from benchmarks.reference.model import Precision
from benchmarks.reference.train import TrainReference, draw

TRACED_STEPS = (1, 2, 3)  # the window's steps the traced run profiles; of calls of k > 1 steps, the second
BETA1 = 0.9



class Setup:
    """The corpus, the loader and its batches on the card."""

    def __init__(self, cell, seed: int, device):
        from osu_diffusion_tpu_torch.data.dataset import BeatmapDatasetIterableFactory, get_data_loader

        tr = cell.traffic
        corpus = tr["corpus"]
        self.device = device
        self.dir = tempfile.mkdtemp(prefix="bench-corpus-")
        maps.write_corpus(self.dir, corpus["maps"], corpus["maps_per_track"], seed, corpus["min_datapoints"])
        tracks = -(-corpus["maps"] // corpus["maps_per_track"])
        lseed = derived_seed(seed, 4) % (2 ** 31)
        self.loader = get_data_loader(
            dataset_path=self.dir, start=0, end=tracks,
            iterable_factory=BeatmapDatasetIterableFactory(tr["seq_len"], tr["stride"], seed=lseed),
            cycle_length=max(1, tr["batch"] // 2), batch_size=tr["batch"], num_workers=tr["loader_threads"],
            shuffle=True, drop_last=True, seed=lseed)
        self.it = iter(self.loader)

    def host_batch(self):
        """The loader's next batch (a new epoch where one ends)."""
        item = next(self.it, None)
        if item is None:
            self.it.close()
            self.it = iter(self.loader)
            item = next(self.it)
        return item

    def to_device(self, item):
        (win, prev_xy), y = item
        b = tuple(torch.from_numpy(a).to(self.device, non_blocking=True) for a in (win, prev_xy, y))
        return b[0], b[1], b[2].long()

    def close(self) -> None:
        self.it.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def build(cell, seed: int, device):
    """The program's model, EMA, optimizer, diffusion and step callable."""
    from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
    from osu_diffusion_tpu_torch.train.train_step import TrainCall, make_ema, make_optimizer, train_step

    tr, cfg = cell.traffic, cell.config
    model = program_model(cfg, device, class_dropout_prob=tr["class_dropout"], remat=tr["remat"],
                          mlp_bwd=tr["mlp_bwd"])
    model.load_state_dict(make_state(cfg, derived_seed(seed, 0), device))
    model.train()
    ema = make_ema(model).eval()
    optimizer = make_optimizer(model.parameters(), lr=tr["lr"])
    diffusion = create_diffusion("", noise_schedule=tr["schedule"], use_l1=tr["l1_loss"], device=device)
    generator = torch.Generator(device=device).manual_seed(derived_seed(seed, 5))
    kwargs = dict(band=tr["seq_len"], dtype=torch.bfloat16 if tr["stream"] == "bf16" else torch.float32,
                  max_timestep=None, mesh=None, context_parallel=False)
    k = tr["steps_per_call"]
    if k == 1:
        def step(batches):
            return train_step(model, ema, optimizer, diffusion, batches[0], generator=generator,
                              ema_decay=tr["ema_decay"], **kwargs)
    else:
        call = TrainCall(model, ema, optimizer, diffusion, generator=generator,
                         graphed=device.type == "cuda", ema_decay=tr["ema_decay"], **kwargs)

        def step(batches):
            return call(tuple(torch.stack(parts) for parts in zip(*batches)))
    return model, ema, optimizer, generator, step


def first_calls(cell, model, ema, optimizer, step, setup: Setup) -> dict:
    """Drive the first calls through the window's own call and feed, and
    read what the comparison needs. A step a call: the losses, the first
    gradient (AdamW's first moment after one step), and after the last
    call AdamW's second moment and the weights' and the EMA's change. Calls
    of k > 1 steps: the first call (its k steps run eagerly as the graph's
    warm-up, then the capture) read the same way, AdamW's first moment in
    the gradient's place; then the second call, a replay of the graph as
    every call of the window is: its loss, AdamW's second moment after it,
    and the weights' and the EMA's change over it (the weights' change also
    whole, on the host, for its direction)."""
    tr = cell.traffic
    k = tr["steps_per_call"]
    params, emas = dict(model.named_parameters()), dict(ema.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}

    def moments(name: str) -> dict:  # AdamW's moments (zeros where it has taken no step)
        return {n: optimizer.state[p].get(name, torch.zeros_like(p)) for n, p in params.items()}

    def since(tensors: dict, before: dict) -> dict:
        return {n: p.detach() - before[n] for n, p in tensors.items()}

    seen = {"batches": [], "losses": [], "grad": None}
    for c in range(tr["first_calls"]):
        if k > 1 and c == 1:  # the state the replay starts from
            seen["first"] = {"moment": norms(moments("exp_avg")), "square": norms(moments("exp_avg_sq")),
                             "change": norms(since(params, start)), "ema_change": norms(since(emas, start))}
            mid = {n: p.detach().clone() for n, p in params.items()}
            mid_ema = {n: p.detach().clone() for n, p in emas.items()}
        group = [setup.to_device(setup.host_batch()) for _ in range(k)]
        seen["batches"] += group
        seen["losses"].append(float(step(group)["l1"]))
        if k == 1 and c == 0:
            seen["grad"] = norms({n: m / (1 - BETA1) for n, m in moments("exp_avg").items()})
    if k == 1:
        seen["first"] = {"grad": seen.pop("grad"), "square": norms(moments("exp_avg_sq")),
                         "change": norms(since(params, start)), "ema_change": norms(since(emas, start))}
    else:
        delta = since(params, mid)
        seen["replay"] = {"square": norms(moments("exp_avg_sq")), "change": norms(delta),
                          "ema_change": norms(since(emas, mid_ema)),
                          "delta": {n: d.cpu() for n, d in delta.items()}}
    return seen


def run(cell, seed: int, seconds: float, trace: bool, device, setup_t0: float) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cuda = device.type == "cuda"
    tr = cell.traffic
    k = tr["steps_per_call"]
    tracer = Tracer()
    setup = Setup(cell, seed, device)
    try:
        model, ema, optimizer, generator, step = build(cell, seed, device)
        g_state = generator.get_state().clone()
        seen = first_calls(cell, model, ema, optimizer, step, setup)
        running = torch.zeros((), device=device)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        setup_s = start - setup_t0
        calls, data_wait, events = 0, 0.0, []
        traced = (TRACED_STEPS if k == 1 else TRACED_STEPS[:1]) if trace else ()
        while time.perf_counter() - start < seconds:
            if calls == (traced[0] if traced else -1):
                tracer.start()
            t0 = time.perf_counter()
            with tracer.span("data_wait"):
                items = [setup.host_batch() for _ in range(k)]
            data_wait += time.perf_counter() - t0
            with tracer.span("h2d"):
                group = [setup.to_device(item) for item in items]
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            with tracer.span("step"):
                metrics = step(group)
            if cuda:
                ev[1].record()
                events.append(ev)
            running.add_(metrics["loss"], alpha=k)  # the trainer's running loss, read at its log steps
            if traced and calls == traced[-1]:
                tracer.stop()
            calls += 1
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - start
        if tracer.prof is not None:
            tracer.stop()
        reserved = torch.cuda.max_memory_reserved(device) if cuda else 0
        kind = torch.cuda.get_device_name(device) if cuda else "cpu"
        device_s = sum(a.elapsed_time(b) for a, b in events) / 1000.0 if cuda else None
        finite = bool(torch.isfinite(running))
        del model, ema, optimizer, step, metrics
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        record = {"kind": "train", "config": cell.config, "traffic": tr, "setup_s": setup_s,
                  "window_s": window_s, "steps": calls * k, "batch": tr["batch"], "attempted": calls * k,
                  "failed": 0 if finite else calls * k, "data_wait_s": data_wait, "device_s": device_s,
                  "window_reserved_peak": reserved, "memory_peak_bytes": reserved, "device_kind": kind,
                  "trace": tracer.summary, "traced_steps": len(traced) * k}
        record["checks"] = check(cell, seen, seed, g_state, device)
    finally:
        setup.close()
    return record


def follow(cell, seen: dict, seed: int, g_state, device, prec: Precision, half_batch: bool = False) -> dict:
    """The reference's readings over the program's first calls, read where
    and as the program's are."""
    tr = cell.traffic
    k = tr["steps_per_call"]
    state = make_state(cell.config, derived_seed(seed, 0), device)
    ref = TrainReference(cell.config, state, band=tr["seq_len"], prec=prec, lr=tr["lr"],
                         ema_decay=tr["ema_decay"], rows=tr["reference_rows"], half_batch=half_batch)
    gen = torch.Generator(device=device)
    gen.set_state(g_state)

    def since(tensors: dict, before: dict) -> dict:
        return {n: tensors[n].detach() - before[n] for n in ref.first_grad}

    losses, out = [], {}
    for i, b in enumerate(seen["batches"]):
        if k > 1 and i == k:  # the first call's end, where the replay starts
            out["first"] = {"moment": norms({n: ref.m[n] for n in ref.first_grad}),
                            "square": norms({n: ref.v[n] for n in ref.first_grad}),
                            "change": norms(since(ref.params, state)), "ema_change": norms(since(ref.ema, state))}
            mid = {n: ref.params[n].detach().clone() for n in ref.first_grad}
            mid_ema = {n: ref.ema[n].clone() for n in ref.first_grad}
        dr = draw(tr["batch"], tr["seq_len"], ref.diffusion.steps, tr["class_dropout"], gen, device)
        losses.append(ref.step(b, dr)[1])
    squares = norms({n: ref.v[n] for n in ref.first_grad})
    if k == 1:
        out["first"] = {"grad": norms(ref.first_grad), "square": squares,
                        "change": norms(since(ref.params, state)), "ema_change": norms(since(ref.ema, state))}
    else:
        losses = [sum(losses[c:c + k]) / k for c in range(0, len(losses), k)]
        delta = since(ref.params, mid)
        out["replay"] = {"square": squares, "change": norms(delta), "ema_change": norms(since(ref.ema, mid_ema)),
                         "delta": delta}
    return {"losses": losses, "first_grad": norms(ref.first_grad), **out}


def readings(cell, prog: dict, ref: dict) -> dict:
    """Each number of `prog` against the reference's `ref` that a limit
    may hold (limits/<cell>.json names those compared), and (under
    "leaves") the leaf that set each worst-leaf number. Numbers of the
    replayed call start with "replay_"; `replay_diff` is the norm of the
    difference of the two changes over the replay, leaf by leaf, which
    reads a change in the wrong direction that its norm does not."""
    counted = checks.counted_leaves(ref["first_grad"])

    def rel(a: float, b: float) -> float:
        return abs(a - b) / abs(b)

    out = {"l1_first": rel(prog["losses"][0], ref["losses"][0]),
           "l1_gap": max(rel(a, b) for a, b in zip(prog["losses"], ref["losses"]))}
    leaves = {}
    for part, prefix in (("first", ""), ("replay", "replay_")):
        for key, theirs in ref.get(part, {}).items():
            if key == "delta":
                continue
            name = prefix + ("ema" if key == "ema_change" else key)
            out[name + "_gap"], leaves[name + "_gap"] = checks.worst_leaf(prog[part][key], theirs, counted)
            out[name + "_median"] = checks.median_leaf(prog[part][key], theirs, counted)[0]
    if "replay" in ref:
        out["replay_l1"] = rel(prog["losses"][1], ref["losses"][1])
        diffs = checks.leaf_diffs(prog["replay"]["delta"], ref["replay"]["delta"])
        gaps = checks.relative_gaps(diffs, ref["replay"]["change"], counted)
        out["replay_diff_gap"], leaves["replay_diff_gap"] = checks.worst_of(gaps)
        out["replay_diff_median"] = checks.median_of(gaps)[0]
    out["leaves"] = leaves
    return out


def check(cell, seen: dict, seed: int, g_state, device) -> list[dict]:
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = follow(cell, seen, seed, g_state, device, Precision())
        found = readings(cell, seen, ref)
    print(f"reference {time.perf_counter() - t0:.1f} s; worst leaves: {found.pop('leaves')}; "
          f"readings {found}", flush=True)
    return checks.compare(found, cell.limits)


def control(cell, seed: int, device, which=("control", "half_batch")) -> dict:
    """On the batches and draws of a run from this seed, the readings of
    the reference in fp8 put in the program's place ("control") and of the
    f32 reference with half of each batch left out, the mean taken over the
    rest ("half_batch"). (A step that returns its state unchanged reads 1
    in the change and the EMA's change by their measure.)"""
    setup = Setup(cell, seed, device)
    try:
        gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 5))
        g_state = gen.get_state().clone()
        tr = cell.traffic
        n = tr["first_calls"] * tr["steps_per_call"]
        seen = {"batches": [setup.to_device(setup.host_batch()) for _ in range(n)]}
        out = {}
        with torch.no_grad():
            ref = follow(cell, seen, seed, g_state, device, Precision())
            if "control" in which:
                out["control"] = readings(cell, follow(cell, seen, seed, g_state, device, Precision("fp8", "fp8")),
                                          ref)
            if "half_batch" in which:
                out["half_batch"] = readings(cell, follow(cell, seen, seed, g_state, device, Precision(),
                                                          half_batch=True), ref)
        return out
    finally:
        setup.close()


def sound(cell, seed: int, device) -> dict:
    """The readings of the program's own first calls from this seed (a
    run's set-up and its comparison, without the window)."""
    setup = Setup(cell, seed, device)
    try:
        model, ema, optimizer, generator, step = build(cell, seed, device)
        g_state = generator.get_state().clone()
        seen = first_calls(cell, model, ema, optimizer, step, setup)
        del model, ema, optimizer, step
        gc.collect()
        torch.cuda.empty_cache()
        with torch.no_grad():
            ref = follow(cell, seen, seed, g_state, device, Precision())
            return readings(cell, seen, ref)
    finally:
        setup.close()
