"""The traced stretch: a ``torch.profiler`` trace of a few units in the
middle of the window, kept in memory and reduced to what the per-layer
readers take.

Device events are the kernels, copies and sets the card ran (the decode
kernels are launched through ``ctypes`` and are seen here by name like any
other). Two stretches follow each other: the first records the card alone
and gives ``busy_s`` (the union of the device intervals) against
``window_s`` (the stretch's length on the host clock, between two
synchronisations) and every device count; the second also records the
host's operations and labels the card's idle gaps by the innermost host
operation running at each gap's middle.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

DECODE_KERNELS = ("mc_decoder_kernel", "llr_decoder_kernel",
                  "qc_decoder_kernel")


@dataclass
class Stretch:
    window_s: float
    busy_s: float
    kernels: list[tuple[str, float]]  # (name, seconds), one per launch
    copies: dict[str, int]  # "DtoH" / "HtoD" / "DtoD" -> count
    device_ops: list[list]  # [name, seconds], most time first, at most 10
    idle_gaps: list[list] = field(default_factory=list)  # [host op, seconds]
    units: list = field(default_factory=list)  # counters of the traced units


def is_decode(name: str) -> bool:
    return any(k in name for k in DECODE_KERNELS)


class Tracer:
    """One profiled stretch. ``host=False`` records the card's activity
    alone, so that the host runs at its own pace and the idle share is the
    card's; ``host=True`` also records the host's operations, which slows
    the host, and serves only to label the idle gaps."""

    def __init__(self, host: bool):
        self.host = host
        self._prof = None
        self.window_s = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                          if self.host else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)

    def events(self) -> list[tuple[str, bool, int, int]]:
        """(name, on the card, start ns, end ns) of every recorded event."""
        from torch.autograd import DeviceType

        return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
                 e.end_ns())
                for e in self._prof.profiler.kineto_results.events()]


def _union(spans: np.ndarray) -> tuple[float, list[tuple[float, float]]]:
    """(covered length, gaps) of [start, end] rows sorted by start."""
    busy, gaps = 0.0, []
    cur0, cur1 = spans[0]
    for t0, t1 in spans[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, t0))
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    return busy + cur1 - cur0, gaps


def _split(events):
    """(device, host) lists of (name, start, end), in seconds from the
    first event."""
    if not events:
        return [], []
    base = min(e[2] for e in events)
    dev, host = [], []
    for name, on_card, t0, t1 in events:
        row = (name, (t0 - base) * 1e-9, (t1 - base) * 1e-9)
        if on_card:
            dev.append(row)
        elif t1 > t0:
            host.append(row)
    return dev, host


def device_stretch(events, window_s: float) -> Stretch:
    """The card's side of a stretch: its kernels, copies and busy time."""
    dev, _ = _split(events)
    kernels, copies, by_name = [], {}, {}
    for name, t0, t1 in dev:
        sec = t1 - t0
        by_name[name] = by_name.get(name, 0.0) + sec
        if name.startswith("Memcpy"):
            kind = name.split()[1]
            copies[kind] = copies.get(kind, 0) + 1
        elif not name.startswith("Memset"):
            kernels.append((name, sec))
    busy = 0.0
    if dev:
        busy = _union(np.asarray(sorted((t0, t1) for _, t0, t1 in dev)))[0]
    top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    return Stretch(window_s, busy, kernels, copies,
                   [[n[:120], s] for n, s in top])


def idle_gaps(events) -> list[list]:
    """The card's idle gaps between its first and last activity, summed by
    the innermost host operation running at each gap's middle (the 500
    longest gaps)."""
    dev, host = _split(events)
    if not dev:
        return []
    spans = np.asarray(sorted((t0, t1) for _, t0, t1 in dev))
    gaps = sorted(_union(spans)[1], key=lambda g: g[0] - g[1])[:500]
    names = [h[0] for h in host]
    h0 = np.asarray([h[1] for h in host])
    h1 = np.asarray([h[2] for h in host])
    labels: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inside = (np.nonzero((h0 <= mid) & (h1 >= mid))[0] if host
                  else np.zeros(0, int))
        label = ("host Python between operations" if inside.size == 0 else
                 names[inside[np.argmin(h1[inside] - h0[inside])]])
        labels[label] = labels.get(label, 0.0) + (g1 - g0)
    return [[n[:120], s] for n, s in
            sorted(labels.items(), key=lambda x: -x[1])[:10]]
