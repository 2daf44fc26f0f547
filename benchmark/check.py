"""The comparison that decides ``correct``.

After the window, a sample of its units drawn from the seed (calls of a
streaming cell, whole sweeps of a sweep cell) is worked out again by the
plain reference from the same keys, and the program's counters are held
against the reference's in two numbers:

* ``frames_gap``: the largest difference, in frames, between the frames
  the program and the reference ran in a compared call or sweep point. The
  count does not depend on rounding, so the comparison is exact (limit 0):
  a frame left out, or a sweep point stopped after another batch, shows.
* ``counter_gap``: over all compared units together, the worst of the
  frame errors, the bit errors of failed frames, the converged frames and
  the sum of their convergence sweeps, each as |program - reference| over
  the larger of the two (0 to 1): a decode that differs in enough frames
  shows, whichever way the counts move.
"""

from __future__ import annotations

import math
import random

from benchmark.reference.sim import COUNTERS


def sample(count: int, k: int, seed: int) -> list[int]:
    """``k`` distinct unit indices of ``count``, drawn from the seed."""
    return sorted(random.Random(seed).sample(range(count), min(k, count)))


def snr_grid(start: float, end: float, step: float) -> list[float]:
    values = []
    for i in range(int(math.ceil((end - start) / step)) + 1):
        v = min(start + i * step, end)
        if not values or v != values[-1]:
            values.append(v)
    return values


def reference_units(ref, traffic: dict, keys: list[int]) -> list[list[dict]]:
    """The reference's counters of each unit, as lists of points."""
    if traffic["kind"] == "stream":
        return [[ref.call(k, traffic["snr_db"], traffic["frames_per_call"])]
                for k in keys]
    grid = snr_grid(*traffic["snr_db"])
    return [[ref.point(k, i, s, traffic["frames_per_point"],
                       traffic["target_errors"]) for i, s in enumerate(grid)]
            for k in keys]


def gaps(program: list[list[dict]], reference: list[list[dict]]) -> dict:
    """``{"frames_gap": (gap, where), "counter_gap": (gap, counter)}`` of
    paired units."""
    flat_p = [p for u in program for p in u]
    flat_r = [r for u in reference for r in u]
    if len(flat_p) != len(flat_r):  # a sweep that ran other points
        return {"frames_gap": (max(sum(p["frames"] for p in flat_p),
                                   sum(r["frames"] for r in flat_r)), "points"),
                "counter_gap": (1.0, "points")}
    frames = max(((abs(p["frames"] - r["frames"]), f"point {i}")
                  for i, (p, r) in enumerate(zip(flat_p, flat_r))),
                 default=(0, "none"))
    worst = (0.0, "none")
    for c in COUNTERS[1:]:
        tp = sum(p[c] for p in flat_p)
        tr = sum(r[c] for r in flat_r)
        worst = max(worst, (abs(tp - tr) / max(tp, tr, 1), c))
    return {"frames_gap": frames, "counter_gap": worst}
