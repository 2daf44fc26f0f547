"""What the ported study scripts share: the device they record, their
comma-separated SNR lists, their point generators, where their TPU records
lie and the comparison of a frame-error count with its record."""

from __future__ import annotations

from pathlib import Path

import torch

EXAMPLES = Path(__file__).resolve().parents[2] / "examples"
"""The committed records, found from the checkout and not the working
directory, so that a study started anywhere compares against them."""


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


def five_se(errors: int, frames: int, ref_errors: int,
            ref_frames: int) -> dict:
    """A frame-error count against its record's: the two FERs' gap, 5
    combined standard errors of that gap (from the pooled FER, the standard
    error the two would share if they measured one FER, which stays
    positive where one count is 0), and whether the gap is within them."""
    import math

    p1, p2 = errors / frames, ref_errors / ref_frames
    p = (errors + ref_errors) / (frames + ref_frames)
    bar = 5 * math.sqrt(p * (1 - p) * (1 / frames + 1 / ref_frames))
    gap = abs(p1 - p2)
    return {"errors": errors, "frames": frames, "record_errors": ref_errors,
            "record_frames": ref_frames, "gap": gap, "five_se": bar,
            "within": gap <= bar}
