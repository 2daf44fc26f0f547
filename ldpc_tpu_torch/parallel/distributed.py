"""Multi-process initialization over ``torch.distributed``.

Counterpart of ``ldpc_tpu/parallel/distributed.py``. One process per card
(or several processes sharing one card) joins one process group; the
meshes of :mod:`ldpc_tpu_torch.parallel.mesh` then lay their axes over the
group's ranks, each rank feeding its shard of the codeword batch or its
share of the SNR points, and the counters ride the group's collectives.

Launch patterns (either set of variables works):

    torchrun --nproc-per-node 2 -m ldpc_tpu_torch.cli --distributed \\
        --mesh batch=2 --matrix ...

    JAX_COORDINATOR_ADDRESS=host0:1234 JAX_NUM_PROCESSES=2 JAX_PROCESS_ID=k \\
        python -m ldpc_tpu_torch.cli --distributed --mesh batch=-1 ...

The backend follows what the ranks have: NCCL when each rank of a host has
a card of its own, gloo on the CPU or when ranks share a card (NCCL refuses
two ranks on one GPU). Under gloo the decode stays on the card and only the
counters pass through the host.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

INIT_TIMEOUT_S = 300  # a rank that never arrives fails the others


def _env_int(*names: str) -> int | None:
    for name in names:
        value = os.environ.get(name)
        if value:
            return int(value)
    return None


def _coordinator() -> str | None:
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        return addr
    host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{host}:{port}" if host and port else None


def local_rank() -> int:
    """This process's index on its host (torchrun's ``LOCAL_RANK``, else
    the global rank)."""
    value = _env_int("LOCAL_RANK")
    if value is not None:
        return value
    return dist.get_rank() if dist.is_initialized() else 0


def choose_backend(world_size: int, device=None) -> str:
    """``nccl`` when each rank on this host has a card of its own, else
    ``gloo`` (the CPU, or ranks sharing a card)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        return "gloo"
    local = _env_int("LOCAL_WORLD_SIZE") or world_size
    return "nccl" if torch.cuda.device_count() >= local else "gloo"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
) -> bool:
    """Join the process group; True once a multi-process group exists.

    The arguments default to ``$JAX_COORDINATOR_ADDRESS`` /
    ``$JAX_NUM_PROCESSES`` / ``$JAX_PROCESS_ID``, or torchrun's
    ``$MASTER_ADDR:$MASTER_PORT`` / ``$WORLD_SIZE`` / ``$RANK``. With none
    of them set the process stays single (False, one line printed), so
    local runs keep working with the same flag; when a coordinator or a
    process count was given, a failed init raises, as does a rank that
    waits more than ``INIT_TIMEOUT_S`` for the others. ``device="cpu"`` asks
    for gloo; on the card each rank takes card ``LOCAL_RANK % count``.
    """
    if dist.is_available() and dist.is_initialized():
        return True
    coordinator_address = coordinator_address or _coordinator()
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK")
    if not coordinator_address and not num_processes:
        print("--distributed: single-process fallback (no coordinator "
              "address or process count set)")
        return False
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError(
            "--distributed needs a coordinator address, a process count and "
            f"a process id (got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r})")
    backend = choose_backend(num_processes, device)
    if torch.cuda.is_available() and (device is None
                                      or torch.device(device).type == "cuda"):
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=timedelta(seconds=INIT_TIMEOUT_S))
    return True


def is_multi_process() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def shutdown() -> None:
    """Leave the process group (a no-op when there is none)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
