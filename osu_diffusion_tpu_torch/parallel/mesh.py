"""The (data, model) process grid (port of osu_diffusion_tpu/parallel/mesh.py).

The JAX package shapes its devices into a `Mesh` over ("data", "model").
Here every rank of the default process group is one device, and the grid
is `world // num_model` rows by `num_model` columns: rank r sits at
(r // num_model, r % num_model). A row is a context-parallel (CP) group:
its ranks hold one batch shard's sequence split over "model". A column is
a data-parallel (DP) shard's ranks; no collective runs over one column (the
gradient sum runs over the whole world), so a column has no group. Each
rank keeps a full replica of the weights (the JAX package also shards them
over "model"; that changes where weights live, not what is computed).
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
    model_rank: int  # column: the sequence shard
    cp_group: object = None  # this rank's row

    @property
    def world(self) -> int:
        return self.num_data * self.num_model


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
    # every rank creates every row's group, in the same order
    rows = [dist.new_group([d * num_model + m for m in range(num_model)]) for d in range(num_data)]
    d, m = divmod(rank, num_model)
    return Mesh(num_data, num_model, d, m, rows[d])
