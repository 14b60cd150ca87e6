"""Traffic of kind "sample": the sample CLI's product loop, one closed-loop
client, one map a request.

Each request runs what `cli.sample_main` composes, with one `Sampler` kept
across requests as a service keeps it: the .osu parsed, featurized and cut
to the map's length, processed, CFG-doubled with fresh noise, the graphed
chain, the decode, and the .osu written under TMPDIR. Map lengths cycle in
the mix's order. The maps are one fixed set (the mix's `map_seed`): their
sliders set the decode's cost, which a map's content drawn from the run's
seed moved by ~1% of a window between seeds. The run's seed draws the
weights, the style labels and the noise. Set-up makes the weights on the
card, writes the cycle's maps, and warms up and captures each bucket's chain with one refine step
(the chain's own cache entry). The window runs whole cycles of the mix:
it starts cycles until --seconds have passed and ends when the last cycle
started completes, so that every run's window holds the same mix of
lengths (a window cut in the middle of a cycle reads 4% apart between
runs as one map more or fewer falls in).

After the window: the written maps checked against the samples, the maps'
featurized rows checked against the files' hit objects, and a sample of
the finished requests drawn from the seed, the longest among them, run
again through the plain reference's chain with the same noise.
"""
from __future__ import annotations

import gc
import os
import random
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmarks.harness import checks, maps
from benchmarks.harness.trace import Tracer
from benchmarks.harness.weights import derived_seed, make_state, program_model
from benchmarks.reference.diffusion import Diffusion
from benchmarks.reference.model import Precision, Reference, quantize_blocks

TRACED_REQUESTS = (1, 2)  # the window's requests the traced run profiles
CHECKED_REQUESTS = 2  # requests run again through the reference: the longest and one drawn
MAP_MARGIN = 16  # generated rows past a map's length, cut off after featurizing



def build_model(cell, state: dict, device):
    """The program's model as the sample CLI loads it: f32, or int8 blocks
    quantized at load."""
    from osu_diffusion_tpu_torch.models.quantize import quantize_state_dict

    quant = cell.traffic["quantize_weights"]
    model = program_model(cell.config, device, quant=quant)
    model.load_state_dict(quantize_state_dict(state) if quant else state)
    return model.eval()


class Client:
    """The product loop over the cycle of maps, on one Sampler."""

    def __init__(self, cell, seed: int, device, tracer: Tracer):
        from osu_diffusion_tpu_torch.diffusion.process import create_diffusion
        from osu_diffusion_tpu_torch.sampling import Sampler

        tr, cfg = cell.traffic, cell.config
        self.cell, self.seed, self.device, self.tracer = cell, seed, device, tracer
        self.model = build_model(cell, make_state(cfg, derived_seed(seed, 0), device), device)
        self.diffusion = create_diffusion(str(tr["steps"]), noise_schedule=tr["schedule"], device=device)
        self.sampler = Sampler(self.model, self.diffusion, cfg_scale=tr["cfg_scale"], band=tr["band"],
                               method="ancestral",
                               compute_dtype=torch.bfloat16 if tr["stream"] == "bf16" else torch.float32)
        self.dir = tempfile.mkdtemp(prefix="bench-maps-")
        self.maps = []
        for k, length in enumerate(tr["lengths"]):
            path = os.path.join(self.dir, f"map{k:02d}.osu")
            with open(path, "w") as f:
                f.write(maps.generate_map(k, 0, tr["map_seed"], length + MAP_MARGIN))
            self.maps.append((path, length))
        self.labels = random.Random(derived_seed(seed, 1))
        self.done: list[dict] = []

    def prepare(self, j: int):
        """Request j's host work before the chain: parse, featurize, cut,
        process, CFG inputs."""
        from osu_diffusion_tpu_torch.beatmap import Beatmap
        from osu_diffusion_tpu_torch.data.featurize import beatmap_to_sequence
        from osu_diffusion_tpu_torch.data.process import split_and_process_sequence_no_augment
        from osu_diffusion_tpu_torch.sampling import prepare_cfg_inputs

        path, length = self.maps[j % len(self.maps)]
        style = self.labels.randrange(self.cell.config["num_classes"])
        gen = torch.Generator(device=self.device).manual_seed(derived_seed(self.seed, 2, j))
        with self.tracer.span("parse"):
            beatmap = Beatmap.from_path(path)
        with self.tracer.span("featurize"):
            rows = beatmap_to_sequence(beatmap)[:length]
        with self.tracer.span("process"):
            seq = torch.from_numpy(rows).to(self.device)
            (_, seq_o, seq_c), _ = split_and_process_sequence_no_augment(seq)
            seq_o = seq_o - seq_o[0]
            inputs = prepare_cfg_inputs(seq_o, seq_c, [style], self.cell.config["num_classes"], gen)
        return beatmap, rows, style, gen, inputs

    def finish(self, j: int, beatmap, rows, style, samples) -> str:
        """Request j's host work after the chain: the decode and the write."""
        from osu_diffusion_tpu_torch.export import create_beatmap

        with self.tracer.span("decode"):
            coords = samples[:1].cpu().numpy()
            seq = np.concatenate([coords[0], rows[:, 2:]], axis=-1)
            new = create_beatmap(seq, beatmap, f"Diffusion {style} 0")
        with self.tracer.span("write"):
            out = os.path.join(self.dir, f"result{j:04d}.osu")
            new.write_path(out)
        return out

    def warm_up(self) -> None:
        """Each bucket's chain captured by one refine step (the same cache
        entry as the request's chain), and the host path run once a map."""
        for j in range(len(self.maps)):
            beatmap, rows, style, gen, (z, o, c, y) = self.prepare(j)
            samples = self.sampler.refine(z, o, c, y, 1, generator=gen)
            self.finish(j, beatmap, rows, style, samples)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        for name in os.listdir(self.dir):
            if name.startswith("result"):
                os.remove(os.path.join(self.dir, name))
        self.labels = random.Random(derived_seed(self.seed, 1))

    def request(self, j: int) -> dict:
        t0 = time.perf_counter()
        beatmap, rows, style, gen, (z, o, c, y) = self.prepare(j)
        t1 = time.perf_counter()
        cuda = self.device.type == "cuda"
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        with self.tracer.span("chain"):
            samples = self.sampler(z, o, c, y, generator=gen)
        if cuda:
            ev[1].record()
        with self.tracer.span("wait"):
            first = samples[:1].cpu()
        t2 = time.perf_counter()
        out = self.finish(j, beatmap, rows, style, first)
        t3 = time.perf_counter()
        length = rows.shape[0]
        return {"j": j, "length": length, "t_pad": -(-length // 128) * 128, "batch": int(z.shape[0]),
                "style": style,
                "host_s": (t1 - t0) + (t3 - t2), "events": ev if cuda else None,
                "chain_s": None if cuda else t2 - t1, "samples": first.numpy()[0], "rows": rows,
                "path": out, "map": self.maps[j % len(self.maps)][0]}

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


def reference_chain(cell, state: dict, req: dict, seed: int, device, prec: Precision, quant_bits) -> np.ndarray:
    """The plain reference's chain for one finished request: the same noise
    drawn in the same order from the request's generator (z, then each
    step's at the bucket's padded length), at the map's real length."""
    tr, cfg = cell.traffic, cell.config
    quant = None if quant_bits is None else quantize_blocks(state, cfg["depth"], quant_bits)
    ref = Reference(cfg, state, prec, quant)
    diff = Diffusion(tr["steps"], device)
    length, t_pad = req["length"], req["t_pad"]
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 2, req["j"]))
    z = torch.randn((1, length, 2), generator=gen, device=device)
    x = torch.cat([z, z])
    o, c = checks.sample_context(torch.from_numpy(req["rows"]).to(device))
    o, c = o[None].expand(2, -1), c[None].expand(2, -1, -1)
    y = torch.tensor([req["style"], cfg["num_classes"]], device=device)
    for i in range(diff.steps - 1, -1, -1):
        noise = torch.randn((2, t_pad, 2), generator=gen, device=device)[:, :length]
        t = torch.full((2,), i, dtype=torch.int64, device=device)
        out = ref.forward_cfg(x, diff.timestep_map[t], o, c, y, tr["cfg_scale"], tr["band"], length)
        x = diff.p_sample(out, x, t, noise)
    return x[0].cpu().numpy()


def checked_requests(done: list[dict], seed: int) -> list[dict]:
    """The longest finished request and others drawn from the seed."""
    if not done:
        return []
    longest = max(done, key=lambda r: (r["length"], -r["j"]))
    rest = [r for r in done if r is not longest]
    rng = random.Random(derived_seed(seed, 3))
    return [longest] + rng.sample(rest, min(CHECKED_REQUESTS - 1, len(rest)))


def run(cell, seed: int, seconds: float, trace: bool, device, setup_t0: float) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"
    tracer = Tracer()
    client = Client(cell, seed, device, tracer)
    try:
        client.warm_up()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        setup_s = start - setup_t0
        done, failed, j = [], 0, 0
        cycle = len(client.maps)
        while time.perf_counter() - start < seconds or j % cycle:
            if trace and j == TRACED_REQUESTS[0]:
                tracer.start()
            try:
                done.append(client.request(j))
            except Exception as e:  # a request that fails is counted, as a service would
                failed += 1
                print(f"request {j} failed: {e!r}", flush=True)
            if trace and j == TRACED_REQUESTS[-1]:
                tracer.stop()
            j += 1
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - start
        if tracer.prof is not None:
            tracer.stop()
        peak = torch.cuda.max_memory_reserved(device) if cuda else 0
        kind = torch.cuda.get_device_name(device) if cuda else "cpu"
        for r in done:
            ev = r.pop("events")
            if ev is not None:
                r["chain_s"] = ev[0].elapsed_time(ev[1]) / 1000.0
        del client.sampler, client.model
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        record = {"kind": "sample", "config": cell.config, "traffic": cell.traffic, "setup_s": setup_s,
                  "window_s": window_s, "attempted": j, "failed": failed,
                  "requests": [{k: r[k] for k in ("length", "t_pad", "batch", "host_s", "chain_s")}
                               for r in done],
                  "traced": [{k: r[k] for k in ("length", "t_pad", "batch")} for r in done
                             if trace and r["j"] in TRACED_REQUESTS],
                  "memory_peak_bytes": peak, "device_kind": kind, "trace": tracer.summary}
        print(f"window {window_s:.3f} s: {len(done)} maps, host {sum(r['host_s'] for r in done):.3f} s, "
              f"chains {sum(r['chain_s'] or 0.0 for r in done):.3f} s on the device", flush=True)
        record["checks"] = check(cell, done, seed, device)
    finally:
        client.close()
    return record


def check(cell, done: list[dict], seed: int, device) -> list[dict]:
    """The numbers compared, each with its limit: the decode's positions
    and the featurizer's rows (exact), and the widest gap between a
    checked request's samples and the reference's."""
    prec = Precision(**cell.traffic["reference_precision"])
    bits = cell.traffic["reference_bits"]
    decode = sum(checks.decode_mismatches(r["path"], r["rows"], r["samples"]) for r in done)
    rows = sum(checks.featurize_mismatches(r["map"], r["rows"]) for r in done)
    t0 = time.perf_counter()
    state = make_state(cell.config, derived_seed(seed, 0), device)
    gap = 0.0
    with torch.no_grad():
        for r in checked_requests(done, seed):
            ref = reference_chain(cell, state, r, seed, device, prec, bits)
            gap = max(gap, float(np.abs(r["samples"] - ref).max()))
    print(f"reference {time.perf_counter() - t0:.1f} s", flush=True)
    found = {"decode_mismatches": decode, "featurize_mismatches": rows, "chain_gap": gap if done else float("inf")}
    return checks.compare(found, cell.limits)
