"""Rank meshes and the sharded SNR sweep step.

Counterpart of ``ldpc_tpu/parallel/mesh.py``. A :class:`Mesh` lays named
axes over the ranks of the process group, one card (or one CPU process) per
rank, row-major in rank order, and carries the two parallel dimensions of
the workload:

  batch -- Monte-Carlo codewords: each rank decodes its slice of every
           batch (drawing the same frames a single process draws there) and
           the counters are summed over the axis;
  snr   -- SNR points: the points of a sweep are dealt over the axis and
           each rank runs its points as one step.

Each axis has a ``torch.distributed`` subgroup (the ranks that differ only
along it). Collectives go through the group's backend: on the card under
NCCL, through the host under gloo.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ldpc_tpu_torch.ops.metrics import BlockStats


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclass
class Mesh:
    """Named axes over the process group's ranks.

    ``devices`` is the int array of ranks in the mesh's shape (the JAX
    mesh's ``devices.shape`` reads the same), ``shape`` maps each axis to
    its size, ``coords`` this rank's coordinate on each axis, ``groups``
    each axis's subgroup (None on a one-rank axis)."""

    axis_names: tuple[str, ...]
    devices: np.ndarray
    rank: int
    groups: dict = field(repr=False)
    backend: str | None = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def coords(self) -> dict[str, int]:
        at = np.argwhere(self.devices == self.rank)[0]
        return dict(zip(self.axis_names, (int(c) for c in at)))

    def size(self, axes) -> int:
        """The number of ranks over ``axes`` (names the mesh lacks count 1)."""
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        idx = 0
        for a in axes:
            if a in self.shape:
                idx = idx * self.shape[a] + self.coords[a]
        return idx

    # ---------------------------------------------------------- collectives --

    def _to_comm(self, t: torch.Tensor) -> torch.Tensor:
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        return wire.contiguous() if self.backend == "nccl" else wire.cpu()

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        """``t`` reduced (``sum`` or ``max``) over the ranks of ``axes``,
        on ``t``'s device."""
        groups = [self.groups[a] for a in axes
                  if a in self.groups and self.groups[a] is not None]
        if not groups:
            return t
        x = self._to_comm(t).clone()
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        for g in groups:
            dist.all_reduce(x, op=red, group=g)
        return x.to(device=t.device, dtype=t.dtype)

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` along ``axis``, concatenated on ``dim`` in
        coordinate order."""
        g = self.groups.get(axis)
        if g is None:
            return t
        x = self._to_comm(t)
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=g)
        return torch.cat(parts, dim=dim).to(device=t.device, dtype=t.dtype)


def make_mesh(axis_sizes: dict[str, int] | None = None) -> Mesh:
    """A mesh over every rank; the default is all of them on one ``batch``
    axis. ``axis_sizes``: e.g. ``{'snr': 2, 'batch': 4}``; a single axis may
    be -1 to absorb the remaining ranks. Every rank must build the same
    meshes in the same order (each builds the subgroups)."""
    n, rank = _world()
    if not axis_sizes:
        axis_sizes = {"batch": n}
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        fixed = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // fixed
    if int(np.prod(sizes)) != n:
        raise ValueError(f"Mesh {dict(zip(names, sizes))} does not cover {n} devices")
    ranks = np.arange(n).reshape(sizes)
    groups: dict = {}
    for ax, name in enumerate(names):
        groups[name] = None
        if sizes[ax] == 1:
            continue
        lines = np.moveaxis(ranks, ax, -1).reshape(-1, sizes[ax])
        for line in lines:  # every rank creates every subgroup, in order
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = g
    backend = dist.get_backend() if n > 1 else None
    return Mesh(tuple(names), ranks, rank, groups, backend)


def sharded_sweep_step(sweep_step, mesh: Mesh, snr_axis: str = "snr"):
    """Deal the points of a sweep over ``snr_axis`` and gather the results.

    ``sweep_step(keys, consts, skips) -> (BlockStats[S_local, B_local],
    iters[S_local])`` runs a list of points as one step over this rank's
    batch shard (``PointExecutor.sweep_step``). It becomes ``sweep(keys[S],
    consts[S], skips[S]) -> (BlockStats[S, B], iters[S])`` on every rank:
    the S points (S a multiple of the axis size) are dealt over
    ``snr_axis`` in contiguous blocks, each point's codeword batch stays
    sharded over the remaining axes, and the results are gathered over all
    of them. ``skips`` (nonzero = skip) lets the caller stop paying for
    points that reached their error quota: a skipped point is not decoded,
    its iters are 0 and its stats placeholders the caller discards. A mesh
    without ``snr_axis`` runs every point on every rank, still as one
    step."""
    batch_axes = tuple(a for a in mesh.axis_names if a != snr_axis)
    s_shard = mesh.shape.get(snr_axis, 1)
    pos = mesh.coords.get(snr_axis, 0)

    def sweep(keys, consts, skips):
        S = len(keys)
        if S % s_shard:
            raise ValueError(f"{S} points do not deal over {snr_axis}={s_shard}")
        lo, hi = pos * S // s_shard, (pos + 1) * S // s_shard
        stats, iters = sweep_step(keys[lo:hi], consts[lo:hi], skips[lo:hi])
        for a in reversed(batch_axes):  # innermost first: row-major rows
            stats = BlockStats(*(mesh.all_gather(x, a, dim=1) for x in stats))
        iters = mesh.all_reduce(iters, batch_axes, op="max")
        if snr_axis in mesh.shape:
            stats = BlockStats(*(mesh.all_gather(x, snr_axis) for x in stats))
            iters = mesh.all_gather(iters, snr_axis)
        return stats, iters

    return sweep
