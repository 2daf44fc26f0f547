"""Rank meshes and sharded Monte-Carlo execution over ``torch.distributed``
(counterpart of ``ldpc_tpu/parallel``)."""

from ldpc_tpu_torch.parallel.mesh import Mesh, make_mesh, sharded_sweep_step

__all__ = ["Mesh", "make_mesh", "sharded_sweep_step"]
