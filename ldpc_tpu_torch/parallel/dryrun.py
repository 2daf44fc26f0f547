"""Multi-process dry run of the sharded SNR sweep step.

Counterpart of ``__graft_entry__.py`` ``dryrun_multichip`` (``:40-151``):
:func:`dryrun_multiprocess` spawns ``n`` ranks on this host, each joins one
``torch.distributed`` group and builds the mesh ``{'snr': 2, 'batch':
n // 2}`` (``{'batch': n}`` when ``n`` is odd), and runs the sweep step on
stacked SNR points. Each rank checks that a skip-masked point ran 0
iterations while the other points decoded, and that the gathered counters
equal a one-process run of the same keys.

    python -m ldpc_tpu_torch.parallel.dryrun 2            # on the card
    python -m ldpc_tpu_torch.parallel.dryrun 2 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A free TCP port on localhost for the process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv_of, n: int, timeout_s: float) -> list[str]:
    """Start ``n`` processes (``argv_of(rank)``) together and wait for all;
    every one is stopped if any is still running at ``timeout_s``. Returns
    their outputs; raises if one failed. Each rank finds this checkout first
    on its path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen(argv_of(r), env=env, cwd=str(REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"ranks still running after {timeout_s} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{out[-3000:]}")
    return outs


def _rank(rank: int, world: int, port: int, device: str | None,
          out: str) -> None:
    import numpy as np
    import torch

    from ldpc_tpu_torch.models.code import LDPCCode
    from ldpc_tpu_torch.models.generate import gallager_regular
    from ldpc_tpu_torch.parallel.distributed import (
        initialize_distributed,
        shutdown,
    )
    from ldpc_tpu_torch.parallel.mesh import make_mesh, sharded_sweep_step
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, derive_key

    if device == "cpu":
        torch.set_num_threads(1)
    started = initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                     device=device)
    if world > 1 and not started:
        raise RuntimeError("the process group did not start")
    snr_axis = 2 if world % 2 == 0 and world > 1 else 1
    batch_axis = world // snr_axis
    mesh = make_mesh({"snr": snr_axis, "batch": batch_axis})
    # a tiny code and batch: this proves the sharding and the collectives
    code = LDPCCode(alist=gallager_regular(48, 3, 6, seed=3),
                    name="dryrun_48_24")
    opts = SimOptions(matrix=code.name, blocks=batch_axis * 4, iterations=4,
                      ber=True, fer=True, fidelity="exact",
                      batch=batch_axis * 4)
    ex = PointExecutor(code, opts, device=device, mesh=mesh, step_vmapped=True)
    snrs = np.linspace(0.0, 3.0, snr_axis)
    consts = [ex.consts(float(s)) for s in snrs]
    keys = [derive_key(0, i) for i in range(snr_axis)]
    sweep = sharded_sweep_step(ex.sweep_step, mesh, "snr")
    stats, iters = sweep(keys, consts, [0] * snr_axis)
    if tuple(stats.ok.shape) != (snr_axis, opts.batch) \
            or tuple(iters.shape) != (snr_axis,):
        raise AssertionError(f"shapes {tuple(stats.ok.shape)}, "
                             f"{tuple(iters.shape)}")
    skipped = None
    if snr_axis > 1:
        _, iters2 = sweep(keys, consts, [1] + [0] * (snr_axis - 1))
        skipped = int(iters2[0])
        if skipped != 0 or int(iters2[1]) <= 0:
            raise AssertionError(f"skip-masked iters {iters2.tolist()}")
    # the same keys through one unmeshed executor in this process
    single = PointExecutor(code, opts, device=device, step_vmapped=True)
    stats1, iters1 = single.sweep_step(keys, consts, [0] * snr_axis)
    for name, a, b in zip(stats._fields, stats, stats1):
        if not torch.equal(a, b):
            raise AssertionError(f"mesh-sharded counter {name!r} != one process")
    if not torch.equal(iters, iters1):
        raise AssertionError("iters != one process")
    with open(out, "w", encoding="utf-8") as f:
        json.dump({"rank": rank, "mesh": mesh.shape,
                   "ok": int(stats.ok.sum()), "frames": int(stats.ok.numel()),
                   "skipped_iters": skipped,
                   "counters": [x.tolist() for x in stats]}, f)
    shutdown()


def dryrun_multiprocess(n: int, device: str | None = None,
                        timeout_s: float = 600.0) -> dict:
    """Spawn ``n`` ranks and run the sharded sweep step (see the module
    docstring); returns rank 0's report. ``device=None`` means the card
    (ranks that share it talk over gloo), ``"cpu"`` the CPU."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(n)]
        run_ranks(lambda r: [sys.executable, "-m", "ldpc_tpu_torch.parallel."
                             "dryrun", str(n), "--rank", str(r), "--port",
                             str(port), "--out", outs[r]]
                  + (["--device", device] if device else []), n, timeout_s)
        reports = [json.load(open(o, encoding="utf-8")) for o in outs]
    if any(r["counters"] != reports[0]["counters"] for r in reports):
        raise AssertionError("ranks disagree on the gathered counters")
    rep = reports[0]
    print(f"dryrun_multiprocess OK: mesh={rep['mesh']}, decoded ok "
          f"{rep['ok']}/{rep['frames']}"
          + (", skip-masked point ran 0 iterations"
             if rep["skipped_iters"] == 0 else "")
          + ", counters == one process")
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="number of ranks")
    ap.add_argument("--device", default=None, help="cpu, or the card")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is None:
        dryrun_multiprocess(args.n, args.device)
    else:
        _rank(args.rank, args.n, args.port, args.device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
