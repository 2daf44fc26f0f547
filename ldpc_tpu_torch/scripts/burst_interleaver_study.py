"""Interleaving doing PHYSICAL work: mode-2 symbol jamming x 16-QAM.

Counterpart of the JAX package's ``scripts/burst_interleaver_study.py``. The
one channel where interleaving can change FER is mode-2 partial-band
interference over multi-bit QAM symbols: a jam draw hits a WHOLE complex
symbol (``ops/modem.py`` jams both I and Q, all bps bits), so adjacent coded
bits fail together, and Gray mapping gives the bits within a symbol unequal
reliability in a fixed periodic pattern. Interleaving between the encoder
and the symbol mapper decorrelates both structures from the code's graph.

The study: WiMAX (576, 288), 16-QAM, mode 2 at fixed (p, interference
depth), FER vs Eb/N0 for interleaver in {none, regular, random, srandom}
plus an S-parameter sweep for srandom and the adversarial permutation (the
positive control), each point to a fixed frame-error target; the unfused
path, through K3.

Writes ``<out>/{results.json,adversarial_pi.npy}`` (default
``build/burst_interleaver``); computes the adversarial permutation itself
and resumes nothing.

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.burst_interleaver_study``
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np

from ldpc_tpu_torch.scripts.study import device_label, floats


def adversarial_permutation(code, bps: int, seed: int = 0):
    """pi concentrating each transmitted symbol's bits onto ONE check.

    interleave semantics: out[i] = bits[pi[i]], so transmitted symbol t
    carries code bits pi[bps*t .. bps*t+bps-1]. Assigning those from a
    single check row's variable neighborhood makes every jammed symbol
    wipe ``bps`` inputs of one check simultaneously -- the burst-damage
    concentration that standard interleavers exist to prevent. This is the
    study's positive control: if FER degrades here while none/regular/
    random/s-random agree, the mechanism (symbol bursts x check
    neighborhoods) is real.
    """
    H = code.H.to_dense()
    m, n = H.shape
    rng = np.random.default_rng(seed)
    neigh = [np.nonzero(H[r])[0].tolist() for r in range(m)]
    for r in range(m):
        rng.shuffle(neigh[r])
    assigned = np.zeros(n, bool)
    pi = []
    order = rng.permutation(m)
    # cycle checks, taking bps unassigned neighbors at a time
    progress = True
    while len(pi) + bps <= n and progress:
        progress = False
        for r in order:
            take = [v for v in neigh[r] if not assigned[v]][:bps]
            if len(take) == bps and len(pi) + bps <= n:
                pi.extend(take)
                assigned[np.asarray(take)] = True
                progress = True
    rest = np.nonzero(~assigned)[0]
    pi.extend(rest.tolist())
    return np.asarray(pi, np.int32)


def wilson(err: int, n: int, z: float = 1.96) -> tuple[float, float]:
    if n == 0:
        return 0.0, 1.0
    p = err / n
    d = 1 + z * z / n
    c = p + z * z / (2 * n)
    h = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return (c - h) / d, (c + h) / d


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/burst_interleaver")
    ap.add_argument("--code", default="builtin:wimax_576_0.5.alist.txt")
    ap.add_argument("--snr", default="5.5,5.75,6.0,6.25,6.5",
                    help="Eb/N0 points (dB), speed=rate")
    ap.add_argument("--p", type=float, default=0.15,
                    help="per-symbol jam probability")
    ap.add_argument("--interference-snr", type=float, default=-3.0,
                    help="jammer SNR (dB): deep bursts")
    ap.add_argument("--target-errors", type=int, default=800)
    ap.add_argument("--max-blocks", type=int, default=400_000)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--s-sweep", default="2,6,10,16")
    return ap


def configs(adv_path: Path, s_sweep: str) -> list[tuple[str, str, int]]:
    """``(label, interleaver, s_param)`` of every row, in the JAX script's
    order."""
    rows = [("none", "none", 2), ("regular", "regular", 2),
            ("random", "random", 2)]
    rows += [(f"srandom_S{int(s)}", "srandom", int(s))
             for s in s_sweep.split(",")]
    rows += [("adversarial", f"file:{adv_path}", 2)]
    return rows


def run_row(code, args, il: str, s_param: int, snrs, dev,
            label: str = "") -> dict:
    """One interleaver's row: each SNR point to ``--target-errors`` frame
    errors (at most ``--max-blocks`` frames), with its Wilson interval."""
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor

    opts = SimOptions(
        matrix=args.code, blocks=args.max_blocks, iterations=12,
        ber=True, fer=True, fidelity="exact", batch=args.batch,
        seed=3, speed=code.k / code.n, schedule="layered",
        mode=2, modulation=16, p=args.p,
        interference_snr=args.interference_snr,
        interleaver=il, s_param=s_param,
        target_errors=args.target_errors, quiet=True,
    )
    ex = PointExecutor(code, opts, device=dev)
    row = {}
    for i, snr in enumerate(snrs):
        st = ex.run_point(snr, args.max_blocks, 11, i)
        lo, hi = wilson(st.fer_frames, st.blocks)
        row[str(snr)] = {
            "fer": st.fer_frames / st.blocks, "fer_lo": lo,
            "fer_hi": hi, "blocks": st.blocks,
            "errors": st.fer_frames,
        }
        print(f"{label:14s} @ {snr:.2f} dB: FER "
              f"{st.fer_frames / st.blocks:.3e} "
              f"[{lo:.3e}, {hi:.3e}] ({st.blocks} blocks, "
              f"kernel={ex.kernel_used})", flush=True)
    row["kernel"] = ex.kernel_used
    return row


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)

    from ldpc_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()

    from ldpc_tpu_torch.sim.runner import load_code
    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    code = load_code(args.code)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    snrs = floats(args.snr)
    label = device_label(dev)
    print(f"# device={label} code={code.name} 16-QAM mode-2 "
          f"p={args.p} jam_snr={args.interference_snr} dB", flush=True)

    adv_path = out / "adversarial_pi.npy"
    np.save(adv_path, adversarial_permutation(code, bps=4, seed=7))
    results: dict = {}
    for name, il, s_param in configs(adv_path, args.s_sweep):
        results[name] = run_row(code, args, il, s_param, snrs, dev, name)
        (out / "results.json").write_text(json.dumps(
            {"code": code.name, "p": args.p,
             "interference_snr_db": args.interference_snr,
             "modulation": 16, "mode": 2, "device": label,
             "target_errors": args.target_errors, "rows": results},
            indent=1))
    print(f"# wrote {out}/results.json", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
