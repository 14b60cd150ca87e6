"""Checkpoints for the port: reference `.pt` files, the train state, and the
JAX parameter tree.

The port's modules carry the reference torch state-dict names (see
models/dit.py), so a reference checkpoint loads with `load_state_dict`.
A training checkpoint is one `torch.save` dict in the reference layout,
{"model", "ema", "opt", "args", "step"}, written as
`<checkpoint dir>/<step, 7 digits>.pt` (a run with model ranks gathers its
shards into that layout first); `load_checkpoint` takes its EMA weights for
sampling.
`state_dict_from_jax_params` converts the JAX package's flax tree (as numpy
arrays, no jax needed) into that layout; it mirrors
osu_diffusion_tpu/train/checkpoint.py:params_to_torch_state_dict.

Key mapping (flax tree -> torch state dict; flax kernels are (in, out),
torch Linear weights (out, in)):
    xoc_embedder.proj                  -> xoc_embedder.mlp.0
    t_embedder.{fc1,fc2}               -> t_embedder.mlp.{0,2}
    y_embedder.embedding_table         -> y_embedder.embedding_table.weight
    blocks_N.attn.qkv_{kernel,bias}    -> blocks.N.attn.in_proj_{weight,bias}
    blocks_N.attn.out_{kernel,bias}    -> blocks.N.attn.out_proj
    blocks_N.mlp_fc{1,2}               -> blocks.N.mlp.fc{1,2}
    blocks_N.adaLN                     -> blocks.N.adaLN_modulation.1
    final_layer.{linear,adaLN}         -> final_layer.{linear,adaLN_modulation.1}
(the stacked layout keeps every block under "blocks" with a leading depth
axis instead of blocks_N scopes). The JAX quant tree (DiTConfig.quant:
`qkv_kernel_q`/`qkv_scale`, `out_kernel_q`/`out_scale`, `kernel_q`/`scale`)
maps to the int8 weights of DiT(quant=True): the codes transposed to
(out, in), each scale beside its weight as `in_proj_scale` or `<layer>.scale`
(see models/dit.py).
"""
from __future__ import annotations

import argparse
import os
from typing import Any

import numpy as np
import torch

from osu_diffusion_tpu_torch import PLAYFIELD
from osu_diffusion_tpu_torch.parallel.sharding import gather_optimizer_state, gather_state_dict


def _t(w) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).T))


def _a(w) -> torch.Tensor:
    return torch.from_numpy(np.array(w))


def _index_tree(tree: dict, i: int) -> dict:
    return {k: _index_tree(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in tree.items()}


def state_dict_from_jax_params(
    params: dict, num_label_rows: int | None = None
) -> dict[str, torch.Tensor]:
    """JAX DiT params (nested dicts of arrays; unrolled `blocks_N` or stacked
    `blocks` layout) -> the port's state dict. `num_label_rows` (num_classes
    + 1) slices off the rows the JAX label table pads to a multiple of 16."""
    sd: dict[str, torch.Tensor] = {}
    sd["xoc_embedder.mlp.0.weight"] = _t(params["xoc_embedder"]["proj"]["kernel"])
    sd["xoc_embedder.mlp.0.bias"] = _a(params["xoc_embedder"]["proj"]["bias"])
    sd["xoc_embedder.playfield_size"] = torch.tensor(PLAYFIELD, dtype=torch.float32)
    sd["t_embedder.mlp.0.weight"] = _t(params["t_embedder"]["fc1"]["kernel"])
    sd["t_embedder.mlp.0.bias"] = _a(params["t_embedder"]["fc1"]["bias"])
    sd["t_embedder.mlp.2.weight"] = _t(params["t_embedder"]["fc2"]["kernel"])
    sd["t_embedder.mlp.2.bias"] = _a(params["t_embedder"]["fc2"]["bias"])
    table = np.asarray(params["y_embedder"]["embedding_table"]["embedding"])
    if num_label_rows is not None:
        table = table[:num_label_rows]
    sd["y_embedder.embedding_table.weight"] = _a(table)

    if "blocks" in params:
        stacked = params["blocks"]
        depth = np.asarray(stacked["adaLN"]["bias"]).shape[0]
        blocks = [_index_tree(stacked, i) for i in range(depth)]
    else:
        blocks = []
        while f"blocks_{len(blocks)}" in params:
            blocks.append(params[f"blocks_{len(blocks)}"])
    for i, b in enumerate(blocks):
        p = f"blocks.{i}."
        attn = b["attn"]
        if "qkv_kernel_q" in attn:  # the int8 serving tree
            sd[p + "attn.in_proj_weight"] = _t(attn["qkv_kernel_q"])
            sd[p + "attn.in_proj_scale"] = _a(attn["qkv_scale"])
            sd[p + "attn.in_proj_bias"] = _a(attn["qkv_bias"])
            sd[p + "attn.out_proj.weight"] = _t(attn["out_kernel_q"])
            sd[p + "attn.out_proj.scale"] = _a(attn["out_scale"])
        else:
            sd[p + "attn.in_proj_weight"] = _t(attn["qkv_kernel"])
            sd[p + "attn.in_proj_bias"] = _a(attn["qkv_bias"])
            sd[p + "attn.out_proj.weight"] = _t(attn["out_kernel"])
        sd[p + "attn.out_proj.bias"] = _a(attn["out_bias"])
        for jax_name, name in (("mlp_fc1", "mlp.fc1"), ("mlp_fc2", "mlp.fc2"),
                               ("adaLN", "adaLN_modulation.1")):
            layer = b[jax_name]
            if "kernel_q" in layer:
                sd[f"{p}{name}.weight"] = _t(layer["kernel_q"])
                sd[f"{p}{name}.scale"] = _a(layer["scale"])
            else:
                sd[f"{p}{name}.weight"] = _t(layer["kernel"])
            sd[f"{p}{name}.bias"] = _a(layer["bias"])
    fl = params["final_layer"]
    sd["final_layer.adaLN_modulation.1.weight"] = _t(fl["adaLN"]["kernel"])
    sd["final_layer.adaLN_modulation.1.bias"] = _a(fl["adaLN"]["bias"])
    sd["final_layer.linear.weight"] = _t(fl["linear"]["kernel"])
    sd["final_layer.linear.bias"] = _a(fl["linear"]["bias"])
    return sd


def load_train_checkpoint(ckpt_path: str) -> dict[str, Any]:
    """The whole dict of a `.pt` file, loaded on the CPU with torch's
    weights-only unpickler."""
    if not os.path.isfile(ckpt_path):
        raise FileNotFoundError(f"no DiT checkpoint at {ckpt_path}")
    # reference training checkpoints also pickle their argparse Namespace
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(ckpt_path, map_location="cpu", weights_only=True)


def load_optimizer_state(optimizer: torch.optim.Optimizer, opt_sd: dict) -> None:
    """optimizer.load_state_dict(opt_sd), each group keeping the live
    optimizer's `capturable`: torch would copy the file's flag over it, and
    the flag says where the step counts live (on the card for a capturable
    AdamW, train_step.make_optimizer), so a checkpoint written on a card
    resumes on the CPU and the other way round."""
    groups = [{**saved, "capturable": live["capturable"]}
              for saved, live in zip(opt_sd["param_groups"], optimizer.param_groups)]
    optimizer.load_state_dict({**opt_sd, "param_groups": groups})


def save_checkpoint(checkpoint_dir: str, step: int, model, ema, optimizer, args: dict,
                    mesh=None) -> str | None:
    """Write {"model", "ema", "opt", "args", "step"} to
    `<checkpoint_dir>/<step:07d>.pt` (through a temporary file, so a reader
    never sees half a checkpoint); returns the path. With `mesh` (model and
    EMA sharded by parallel/sharding.py, with or without CP) every rank
    of the mesh's row calls it: the model, EMA and AdamW moments are
    gathered whole, in a one-process run's layout, and the row's first rank
    writes them (the others return None)."""
    if mesh is None:
        parts = model.state_dict(), ema.state_dict(), optimizer.state_dict()
    else:
        parts = (gather_state_dict(model, mesh), gather_state_dict(ema, mesh),
                 gather_optimizer_state(optimizer, model, mesh))
        if mesh.model_rank:
            return None
    path = os.path.join(checkpoint_dir, f"{step:07d}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": parts[0], "ema": parts[1], "opt": parts[2], "args": dict(args),
                "step": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(checkpoint_dir: str) -> str | None:
    """The checkpoint of the highest step in `checkpoint_dir`, or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    steps = [name[:-3] for name in os.listdir(checkpoint_dir)
             if name.endswith(".pt") and name[:-3].isdigit()]
    if not steps:
        return None
    return os.path.join(checkpoint_dir, max(steps, key=int) + ".pt")


def load_checkpoint(ckpt_path: str) -> dict[str, Any]:
    """State dict from a reference `.pt` file: a training checkpoint
    {"model", "ema", "opt", "args", ...} (the EMA weights when there are
    any) or a raw state dict. Loaded with torch's weights-only unpickler."""
    ckpt = load_train_checkpoint(ckpt_path)
    for key in ("ema", "model"):
        if key in ckpt:
            ckpt = ckpt[key]
            break
    pf = ckpt.get("xoc_embedder.playfield_size")
    if pf is not None and not torch.allclose(torch.as_tensor(pf, dtype=torch.float32),
                                             torch.tensor(PLAYFIELD)):
        raise ValueError(f"unexpected playfield_size in checkpoint: {pf}")
    return ckpt
