"""Readings that set a cell's limits: the program's compared numbers and the
control's, over many seeds in one process, at the cell's own sizes.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

For each seed it draws the units a run with that seed compares (as if its
window held :data:`WINDOW_UNITS` units), runs them through the program, the
float32 reference and the control (the reference computed in the nearest
precision below the configuration's float32: bfloat16), and prints the
program's compared numbers and the control's, each against the float32
reference, one JSON line a seed and a summary line last. The benchmark's
own runs never run it. It needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

WINDOW_UNITS = 100


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    import torch

    from benchmark import cells, check
    from benchmark.harness import unit_key
    from benchmark.program import Program, use_build_dir
    from benchmark.reference.sim import Reference

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = cells.load(args.workload)
    use_build_dir()
    program = Program(cell.config, cell.traffic)
    program.start()
    unit = program.call if cell.traffic["kind"] == "stream" else program.sweep
    ref = Reference(cell.config, "cuda")
    ctl = Reference(cell.config, "cuda", dtype=torch.bfloat16)
    prog_gaps, ctl_gaps = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        keys = [unit_key(seed, i) for i in
                check.sample(WINDOW_UNITS, cell.check["units"], seed)]
        t = time.perf_counter()
        outs = [unit(k) for k in keys]
        outs = [[o] if isinstance(o, dict) else o for o in outs]
        r = check.reference_units(ref, cell.traffic, keys)
        c = check.reference_units(ctl, cell.traffic, keys)
        pg, cg = check.gaps(outs, r), check.gaps(c, r)
        prog_gaps.append(pg)
        ctl_gaps.append(cg)
        print(json.dumps({"seed": seed, "program": pg, "control": cg,
                          "counters": {"reference": r, "control": c,
                                       "program": outs},
                          "seconds": time.perf_counter() - t}), flush=True)
    print(json.dumps({
        "workload": cell.name, "seeds": len(prog_gaps),
        "program_max": {n: max(g[n][0] for g in prog_gaps)
                        for n in prog_gaps[0]},
        "control_min": {n: min(g[n][0] for g in ctl_gaps)
                        for n in ctl_gaps[0]},
        "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
