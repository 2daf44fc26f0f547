"""The operations an LDPC decode needs, counted from the algorithm, and the
card's published peaks: the yardstick of the roofline metrics.

Frozen copy of the simulator's census (``decode_census``, ``channel_census``,
``counter_census``, ``init_census``, ``lane_sweeps``): element operations per
codeword, one instruction each, by class; a check-node update, a roll along
Z, a compare-and-select. They count what the data needs, the same whatever
decodes it. ``benchmark/test_bench_census.py`` holds the copy equal to the
program's on both configurations.

A least time is the larger of the operations at the issue peak (one float32
instruction per lane per clock: SMs x 128 lanes x the highest SM clock; the
kernels are built without fused multiply-adds, so an instruction is one
operation) and the bytes in and out at the memory bandwidth.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

CLASSES = ("fma", "roll", "where", "tanh", "log", "div", "sqrt", "cossin",
           "prng")

# published figures by card name: SMs, f32 lanes per SM, highest SM clock
# (Hz), HBM bandwidth (bytes/s); NVIDIA H100 SXM5 data sheet
PEAKS = {"H100": {"sms": 132, "lanes": 128, "clock_hz": 1.98e9,
                  "hbm_bytes_per_s": 3.35e12}}


def peaks(device_name: str) -> dict | None:
    """``{"ops_per_s", "bytes_per_s"}`` of a card, None for a card with no
    published figures here."""
    for key, p in PEAKS.items():
        if key in device_name:
            return {"ops_per_s": p["sms"] * p["lanes"] * p["clock_hz"],
                    "bytes_per_s": p["hbm_bytes_per_s"]}
    return None


def least_time(ops: float, nbytes: float, device_name: str):
    """(seconds, "operations" | "bytes") or None."""
    p = peaks(device_name)
    if p is None:
        return None
    t_ops, t_bytes = ops / p["ops_per_s"], nbytes / p["bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@dataclass
class OpCount:
    counts: dict[str, float] = field(
        default_factory=lambda: dict.fromkeys(CLASSES, 0.0))

    def add(self, cls: str, n: float) -> None:
        self.counts[cls] += n

    def __add__(self, other: "OpCount") -> "OpCount":
        out = OpCount()
        for c in CLASSES:
            out.counts[c] = self.counts[c] + other.counts[c]
        return out

    def total(self) -> float:
        return sum(self.counts.values())


def exclusive_combine(values, op):
    """Leave-one-out fold: ``op(prefix[i], suffix[i])``, None the identity."""

    def op2(a, b):
        if a is None:
            return b
        if b is None:
            return a
        return op(a, b)

    d = len(values)
    prefix = [None] * d
    suffix = [None] * d
    for i in range(1, d):
        prefix[i] = op2(prefix[i - 1], values[i - 1])
        suffix[d - 1 - i] = op2(suffix[d - i], values[d - i])
    return [op2(p, s) for p, s in zip(prefix, suffix)]


def _count_exclusive(d: int) -> int:
    ops = 0

    def op(a, b):
        nonlocal ops
        ops += 1
        return a

    exclusive_combine(list(range(d)), op)
    return ops


def _check_update_census(c: OpCount, Z: int, d: int, variant: str) -> None:
    if variant == "spa":
        c.add("fma", d * Z * 5)
        c.add("tanh", d * Z)
        c.add("fma", _count_exclusive(d) * Z)
        c.add("fma", d * Z * 4)
        c.add("div", d * Z)
        c.add("log", d * Z)
        return
    c.add("where", d * Z)
    c.add("fma", d * Z)
    c.add("fma", 2 * _count_exclusive(d) * Z)
    if variant == "normalized_minsum":
        c.add("fma", d * Z)
    elif variant == "offset_minsum":
        c.add("fma", d * Z * 2)
    c.add("fma", d * Z)


def decode_census(qc, variant: str = "spa", schedule: str = "layered",
                  track_norm: bool = False, check_every: int = 1) -> OpCount:
    """Element-ops of one decode sweep per codeword."""
    Z, nb, mb = qc.Z, qc.nb, qc.mb
    row_slots = qc.row_slots()
    c = OpCount()

    def roll(s, into=None):
        if s % Z:
            (into if into is not None else c).add("roll", Z)

    for bi in range(mb):
        slots = row_slots[bi]
        d = len(slots)
        for _, s in slots:
            roll(s)
        c.add("fma", d * Z)
        _check_update_census(c, Z, d, variant)
        if schedule == "layered":
            ncols = len({bj for bj, _ in slots})
            if ncols < d:
                c.add("fma", d * Z)
                for _, s in slots:
                    roll(-s)
                c.add("fma", ncols * Z)
                c.add("where", ncols * Z)
            else:
                c.add("fma", d * Z)
                for _, s in slots:
                    roll(-s)
                c.add("where", d * Z)
            c.add("where", d * Z)
        else:
            c.add("where", d * Z)

    if schedule == "flooding":
        for bj in range(nb):
            for _, _, s in qc.col_slots()[bj]:
                roll(-s)
                c.add("fma", Z)

    syn = OpCount()
    for bi in range(mb):
        for _, s in row_slots[bi]:
            roll(s, into=syn)
        d = len(row_slots[bi])
        syn.add("fma", 2 * d * Z)
        syn.add("fma", Z)
        syn.add("fma", 1)
    for cls, cnt in syn.counts.items():
        c.add(cls, cnt / check_every)
    if track_norm:
        c.add("fma", nb * (7 * Z + Z))
        c.add("fma", nb)
        c.add("where", 1)
    c.add("where", 2 / check_every)
    return c


def channel_census(qc, mode: int = 1) -> OpCount:
    """Element-ops per codeword of the fused channel fill (noise words,
    Box-Muller, LLRs), with the error count and the decode's init."""
    Z, nb = qc.Z, qc.nb
    c = OpCount()

    def normal_pair():
        c.add("prng", 3 * Z)
        c.add("fma", (7 + 4) * Z)
        c.add("log", Z)
        c.add("sqrt", Z)
        c.add("fma", 2 * Z)
        c.add("cossin", 2 * Z)
        c.add("fma", 2 * Z)

    for _ in range((nb + 1) // 2):
        normal_pair()
        if mode != 1:
            normal_pair()
    for _ in range(nb):
        c.add("fma", 5 * Z)
        if mode == 2:
            c.add("prng", Z)
            c.add("fma", (4 + 1) * Z)
            c.add("fma", 3 * Z)
            c.add("where", Z)
        elif mode == 3:
            c.add("fma", 5 * Z)
    return c + counter_census(qc) + init_census(qc)


def counter_census(qc) -> OpCount:
    c = OpCount()
    c.add("fma", qc.nb * (4 * qc.Z + qc.Z))
    c.add("fma", qc.nb)
    return c


def init_census(qc) -> OpCount:
    c = OpCount()
    c.add("fma", qc.n)
    c.add("fma", sum(len(r) for r in qc.row_slots()) * qc.Z)
    return c


def lane_sweeps(ok: np.ndarray, conv: np.ndarray, max_it: int) -> np.ndarray:
    """Sweeps each codeword's data needs: through its converging check
    window, or the whole budget."""
    return np.where(ok, conv.astype(np.int64) + 1, max_it)


def total_sweeps(frames: int, converged: int, conv_sum: int,
                 max_it: int) -> int:
    """``lane_sweeps`` summed, from a run's counters."""
    return conv_sum + converged + (frames - converged) * max_it
