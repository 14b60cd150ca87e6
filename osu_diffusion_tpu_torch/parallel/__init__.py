"""Data, context and tensor parallelism over `torch.distributed` (port of
osu_diffusion_tpu/parallel: mesh.py, context.py and sharding.py)."""
from osu_diffusion_tpu_torch.parallel.context import context_parallel_banded_attention
from osu_diffusion_tpu_torch.parallel.mesh import Mesh, make_mesh
from osu_diffusion_tpu_torch.parallel.sharding import (
    gather_state_dict,
    param_partition_spec,
    shard_model,
    shard_state_dict,
)

__all__ = ["Mesh", "context_parallel_banded_attention", "gather_state_dict", "make_mesh",
           "param_partition_spec", "shard_model", "shard_state_dict"]
