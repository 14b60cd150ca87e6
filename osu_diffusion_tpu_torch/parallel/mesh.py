"""The (data, model) process grid (port of osu_diffusion_tpu/parallel/mesh.py).

The JAX package shapes its devices into a `Mesh` over ("data", "model").
Here every rank of the default process group is one device, and the grid
is `world // num_model` rows by `num_model` columns: rank r sits at
(r // num_model, r % num_model).

- A row holds the model ranks of one data shard. They take the same batch
  and the same draws, and every collective of the model runs over the row:
  under context parallelism (CP) the halo exchange of the sequence split
  over "model"; under tensor parallelism (TP, parallel/sharding.py) the
  gather of the adaLN heads' columns, the sum of the MLP's and the label
  table's partial outputs and of their input gradients.
- A column holds the data ranks of one model rank. Under TP a parameter's
  gradient is summed over the column: each rank of a column holds the same
  shard (or the same replica) of every parameter. Under CP over a sharded
  model a sharded parameter's gradient is summed over the column (the row
  summed it in the backward), a replicated one's over the world; under CP
  over a whole model and pure data parallelism every gradient over the
  world.

Where the weights live: with model ranks (TP, and CP as the trainer runs
it) each holds its shard of the MLP, the adaLN heads and the label table
and a replica of the rest; under pure data parallelism every rank holds a
full replica.
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the grid. With world size 1 it has no groups
    and nothing collective runs."""

    num_data: int
    num_model: int
    data_rank: int   # row: the batch shard
    model_rank: int  # column: the sequence shard (CP) or the weight shard (TP)
    row_group: object = None  # this rank's row: the model ranks of its data shard
    col_group: object = None  # this rank's column: the data ranks of its model rank

    @property
    def world(self) -> int:
        return self.num_data * self.num_model

    def __deepcopy__(self, memo):
        # a handle on process groups, shared by the model and its EMA copy
        return self


def make_mesh(num_model: int = 1) -> Mesh:
    """The grid over the default process group (or one process)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if num_model < 1 or world % num_model:
        raise ValueError(f"{world} ranks are not divisible by num_model={num_model} (run one "
                         "process per rank, e.g. under torchrun)")
    num_data = world // num_model
    if world == 1:
        return Mesh(1, 1, 0, 0)
    # every rank creates every row's and every column's group, in the same order
    rows = [dist.new_group([d * num_model + m for m in range(num_model)]) for d in range(num_data)]
    cols = [dist.new_group([d * num_model + m for d in range(num_data)]) for m in range(num_model)]
    d, m = divmod(rank, num_model)
    return Mesh(num_data, num_model, d, m, rows[d], cols[m])
