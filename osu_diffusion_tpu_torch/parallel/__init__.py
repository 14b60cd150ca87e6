"""Data and context parallelism over `torch.distributed` (port of
osu_diffusion_tpu/parallel: mesh.py and context.py; tensor parallelism,
sharding.py, is not ported)."""
from osu_diffusion_tpu_torch.parallel.context import context_parallel_banded_attention
from osu_diffusion_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["Mesh", "context_parallel_banded_attention", "make_mesh"]
