"""One gloo rank of the port's context- and tensor-parallel tests (run by
tests/test_torch_cp.py and tests/test_torch_mesh.py, one subprocess per
rank; imports torch and the port, never jax).

Usage: torch_cp_worker.py <rank> <world> <port> <workdir>

Reads `<workdir>/cases_w<world>.pt`, a dict of numpy inputs made by the test
process, runs every case on this world, and writes this rank's results to
`<workdir>/out_w<world>_r<rank>.pt`:
- "attn": `context_parallel_banded_attention` on the rank's rows of q, k, v,
  and the gradients of sum(sin(out)) over the global rows below `loss_rows`;
- "train": one AdamW + EMA `train_step` on a mesh of `num_model` model
  ranks with the given weights, batch and draws (this rank's DP shard);
- "tp": the same step with the model sharded over the model ranks (tensor
  parallelism, the case's MLP backward): the gathered weights, EMA and
  AdamW moments, and this rank's own tensors;
- "tp_cp": that step with the sharded model under context parallelism
  (the row's ranks split the sequence and hold the shards);
- "sample": a `Sampler(cp=mesh)` chain with the given per-step noise, or
  from a generator of the given seed; with "forward_t", also one
  `forward_with_cfg` at that timestep on the rank's rows, gathered. The
  case may ask for the int8 model ("quant", its state dict already int8)
  and a `matmul_dtype`.
"""
import os
import sys

rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)  # several ranks share the test machine's cores
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=world)

from osu_diffusion_tpu_torch.diffusion.process import create_diffusion  # noqa: E402
from osu_diffusion_tpu_torch.models.dit import DiT  # noqa: E402
from osu_diffusion_tpu_torch.parallel import context_parallel_banded_attention, make_mesh  # noqa: E402
from osu_diffusion_tpu_torch.parallel.context import gather_slots, shard_rows  # noqa: E402
from osu_diffusion_tpu_torch.parallel.sharding import (  # noqa: E402
    gather_optimizer_state,
    gather_state_dict,
    shard_model,
)
from osu_diffusion_tpu_torch.sampling import Sampler, _bucketed, _pad_time  # noqa: E402
from osu_diffusion_tpu_torch.train.train_step import StepDraws, make_ema, train_step  # noqa: E402

cases = torch.load(os.path.join(workdir, f"cases_w{world}.pt"), weights_only=False)
meshes = {}


def mesh_of(num_model):
    """One mesh per model-axis size (every rank creates the same groups in
    the same order)."""
    if num_model not in meshes:
        meshes[num_model] = make_mesh(num_model)
    return meshes[num_model]


def t(a):
    return torch.from_numpy(a)


def run_attn(case):
    mesh = mesh_of(case["num_model"])
    q, k, v = (t(case[name]) for name in ("q", "k", "v"))
    t_loc = q.shape[2] // mesh.num_model
    rows = slice(mesh.model_rank * t_loc, (mesh.model_rank + 1) * t_loc)
    ql, kl, vl = (a[:, :, rows].clone().requires_grad_() for a in (q, k, v))
    out = context_parallel_banded_attention(ql, kl, vl, case["band"], mesh, case["valid_len"],
                                            torch.float32)
    keep = (torch.arange(rows.start, rows.stop) < case["loss_rows"]).to(out.dtype)
    (torch.sin(out) * keep[:, None]).sum().backward()
    return {"out": out.detach(), "dq": ql.grad, "dk": kl.grad, "dv": vl.grad}


def port_model(case):
    model = DiT(matmul_dtype=getattr(torch, case.get("matmul_dtype", "float32")),
                mlp_bwd=case.get("mlp_bwd", "xla"), quant=case.get("quant", False), **case["config"])
    model.load_state_dict({k: t(v) for k, v in case["state_dict"].items()})
    return model


def run_train(case, tp, cp):
    """`tp`: the model sharded over the model ranks; `cp`: the model ranks
    split the sequence."""
    mesh = mesh_of(case["num_model"])
    model = port_model(case).train()
    ema = make_ema(model)
    if tp:
        shard_model(model, mesh)
        shard_model(ema, mesh)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-4,
                            weight_decay=0.0)
    diffusion = create_diffusion("", noise_schedule="squaredcos_cap_v2", use_l1=True)
    b_loc = case["raw"].shape[0] // mesh.num_data
    mine = slice(mesh.data_rank * b_loc, (mesh.data_rank + 1) * b_loc)  # this DP shard
    batch = (t(case["raw"][mine]), t(case["prev_xy"][mine]), t(case["y"][mine]).long())
    d = case["draws"]
    draws = StepDraws(t(d["flip_x"][mine]), t(d["flip_y"][mine]), t(d["offset01"][mine]),
                      t(d["t"][mine]).long(), t(d["noise"][mine]), t(d["drop"][mine]))
    metrics = train_step(model, ema, opt, diffusion, batch, band=case["band"],
                         dtype=torch.float32, draws=draws, ema_decay=0.5, mesh=mesh,
                         context_parallel=cp)
    if tp:
        names = [name for name, _ in model.named_parameters()]
        state = gather_optimizer_state(opt, model, mesh)["state"]
        return {"metrics": {k: v.item() for k, v in metrics.items()},
                "params": gather_state_dict(model, mesh), "ema": gather_state_dict(ema, mesh),
                **{k: {names[i]: s[k] for i, s in state.items()} for k in ("exp_avg", "exp_avg_sq")},
                "local": {k: v.clone() for k, v in model.state_dict().items()}}
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "params": {k: v.clone() for k, v in model.state_dict().items()},
            "ema": {k: v.clone() for k, v in ema.state_dict().items()}}


def run_sample(case):
    mesh = mesh_of(case["num_model"])
    model = port_model(case).eval()
    sampler = Sampler(model, create_diffusion(str(case["steps"])), cfg_scale=case["cfg_scale"],
                      band=case["band"], cp=mesh)
    inputs = (t(case["z"]), t(case["o"]), t(case["c"]), t(case["y"]).long())
    out = {}
    if "forward_t" in case:  # one CFG forward on this rank's rows of the padded inputs
        z, o, c, y = inputs
        t_pad = _bucketed(z.shape[1], sampler.bucket)
        rows = shard_rows(t_pad, mesh)
        with torch.no_grad():
            x, op, cpad = (_pad_time(a, t_pad)[:, rows] for a in (z, o, c))
            fwd = model.forward_with_cfg(x, torch.full((z.shape[0],), case["forward_t"]), op, cpad, y,
                                         case["cfg_scale"], band=case["band"], valid_len=z.shape[1],
                                         cp=mesh)
        out["forward"] = torch.cat(gather_slots(fwd, mesh).unbind(), dim=1)[:, :z.shape[1]]
    if "seed" in case:
        return {**out, "out": sampler(*inputs, generator=torch.Generator().manual_seed(case["seed"]))}
    noise = case["noise"]

    def noise_fn(k, shape):
        assert tuple(shape) == noise[k].shape, (shape, noise[k].shape)
        return t(noise[k])

    return {**out, "out": sampler(*inputs, noise_fn=noise_fn)}


runners = {"attn": run_attn, "train": lambda case: run_train(case, tp=False, cp=True),
           "tp": lambda case: run_train(case, tp=True, cp=False),
           "tp_cp": lambda case: run_train(case, tp=True, cp=True), "sample": run_sample}
results = {kind: [runners[kind](case) for case in kind_cases] for kind, kind_cases in cases.items()}
torch.save(results, os.path.join(workdir, f"out_w{world}_r{rank}.pt"))
dist.barrier()
dist.destroy_process_group()
print(f"rank {rank} of {world} OK", flush=True)
