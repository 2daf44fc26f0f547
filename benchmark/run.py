"""Run one benchmark cell once on the card and print one JSON result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the CUDA context, the kernel
libraries from ``build/benchmark/`` in the checkout, the executor and one
warm-up unit of the cell's own traffic) counts from the process's start to
the window's. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer ones from a profiled stretch of the window. Either way the
window's outputs are checked against the plain reference; the compared
numbers and their limits are the result's last key and the last lines on
standard error. Without a card, or with fewer cards than the cell asks for,
it prints no result and exits 3; if the JAX package or JAX itself was
loaded, it exits 4.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "ldpc_tpu")


def _process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (to 10 ms,
    from /proc), or now where /proc has no answer."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - started / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import cells

    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s), "
              f"this machine has {have}", file=sys.stderr)
        return 3
    from benchmark.harness import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
