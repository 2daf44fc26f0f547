"""Cells, configurations, traffic and metric readers, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic. The files are:

* ``benchmark/configs/<config>.json``: the deployment (code, channel,
  decoder, batch) and the simulator options it is run with;
* ``benchmark/reference/codes/<family>.py``: the reference's copy of a code
  family, ``build(code) -> QCCode``, chosen by the configuration's
  ``code.family`` and held to the ``n``, ``k`` and ``z`` it states;
* ``benchmark/traffic/<traffic>.json``: the traffic mix, read by the one
  generator in ``benchmark/harness.py``;
* ``benchmark/workloads/<cell>.json``: how the cell's outputs are checked
  (units compared and the limit of each compared number);
* ``benchmark/metrics/<metric>.py``: one per-layer reader each, a function
  ``read(ctx)`` that returns a number or None when it finds nothing to read.
  A metric ``<base>.<cells>`` (one quantity split by the end-to-end metric
  its cells report) without a file of its own is read by ``<base>.py``.

A later cell, configuration, code family or metric is a new file and a new
entry in ``BENCHMARK.json``; no existing file changes, as long as the plain
reference already decodes what the cell runs: a quasi-cyclic code under
layered or flooding sum-product (``options.schedule``, flooding where it is
left out, as in the simulator), on the fused BPSK path or the unfused
channel, as streaming calls or as sweeps of ``run_simulation``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the schedules the plain reference decodes
SCHEDULES = ("flooding", "layered")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def schedule(config: dict) -> str:
    """The schedule a configuration decodes: ``options["schedule"]``, or the
    simulator's default, flooding, where the options leave it out. Stops if
    the reference has no decoder for it or ``decoder.schedule`` states
    another."""
    sched = config["options"].get("schedule") or "flooding"
    if sched not in SCHEDULES:
        raise SystemExit(f"schedule {sched!r} is not one of "
                         f"{', '.join(SCHEDULES)} (benchmark/reference/)")
    stated = config.get("decoder", {}).get("schedule", sched)
    if stated != sched:
        raise SystemExit(f"the configuration's decoder states schedule "
                         f"{stated!r}; its options run {sched!r}")
    return sched


def load(name: str, root: Path = ROOT) -> Cell:
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {', '.join(sorted(cells))})")
    w = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    here = root / "benchmark"
    config = _json(root / cfg["file"])
    schedule(config)  # a schedule without a reference stops before set-up
    return Cell(
        name=name, chips=int(w["chips"]),
        config=config,
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        check=_json(here / "workloads" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``, or of
    ``<base>.py`` for a split ``<base>.<cells>`` without a file of its own."""
    here = root / "benchmark" / "metrics"
    path = here / f"{metric}.py"
    if not path.is_file():
        path = here / f"{metric.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
