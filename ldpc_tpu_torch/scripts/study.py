"""What the ported study scripts share: the device they record and their
comma-separated SNR lists."""

from __future__ import annotations

import torch


def device_label(dev: torch.device) -> str:
    """The device a study records where the JAX script records
    ``jax.devices()[0].device_kind``: the card's name with ``nvidia-smi``'s
    name and power limit (``bench.card_line``), or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    from ldpc_tpu_torch.bench import card_line

    return f"{torch.cuda.get_device_name(dev)} ({card_line()})"


def floats(spec: str) -> list[float]:
    """``"2.0,2.5"`` -> ``[2.0, 2.5]``; an empty string gives no points."""
    return [float(s) for s in spec.split(",") if s.strip()]


def generator(key: int, dev: torch.device) -> torch.Generator:
    """A ``torch.Generator`` on ``dev`` seeded from a ``derive_key`` key,
    as the runner seeds its own (``PointExecutor._generator``)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(key >> 1)
    return gen
