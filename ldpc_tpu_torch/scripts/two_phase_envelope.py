"""Two-phase dispatch envelope on the bench code: {off, forced, auto} x SNR.

Counterpart of the JAX package's ``scripts/two_phase_envelope.py`` on one
card. Measures the full pipeline's throughput in the three dispatch modes
(``--two-phase off``, a split forced at 6 phase-1 iterations through K1 and
K2, and ``auto``) at operating points from FER ~1 (0 dB: every frame
re-decodes, where a fixed split is a pure loss) to the deep waterfall (3.5
dB), on the production configuration (layered SPA-12, paired, a check
every 2 sweeps): ``auto`` should never lose to ``off`` by more than its
probe's cost at any point.

Also calibrates the probe's cost model: from the forced-split and
single-pass throughputs and the trip model of one probe batch
(``sim.runner.two_phase_trip_model`` at the kernel's block, ``ex.lanes``
codewords), the overhead implied in block trips,
``single * t_two / t_single - (phase1_mean + phase2_per_tile)``. A K1 block
is one codeword (or the codewords sharing a warp), not the TPU's 128-lane
tile, so these trips are the card's units. Beside it stands what the
port's ``auto`` measured itself (``PointExecutor.last_probe``: the split's
overhead in us and in trips, and the probe's us per block trip), where the
JAX runner takes a constant.

The three modes run the same keys and the counters do not depend on the
split, so each point's FER is equal across them: :func:`main` returns 1
where it is not.

Writes ``<out>/results.json`` (default ``build/two_phase_envelope``).

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.two_phase_envelope``
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

MODES = ("off", "6", "auto")
SNRS = [0.0, 1.0, 2.0, 3.0, 3.5]
PHASE1 = 6
BATCH = 4096  # frames a batch, as in the JAX script


def envelope_executors(code, batch: int, device=None) -> dict:
    """``{two_phase: PointExecutor}`` on the production configuration."""
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor

    base = dict(
        matrix=code.name, blocks=batch, iterations=12, ber=True, fer=True,
        fidelity="exact", batch=batch, seed=0, speed=0.5,
        schedule="layered", layer_order="paired", check_every=2,
    )
    return {tp: PointExecutor(code, SimOptions(two_phase=tp, **base),
                              device=device) for tp in MODES}


def trip_model_of(ex, snr: float, key: int) -> dict:
    """The trip model of one single-pass probe batch at ``snr`` (a split
    at :data:`PHASE1` of 12 iterations, blocks of ``ex.lanes``)."""
    from ldpc_tpu_torch.sim.runner import two_phase_trip_model

    block, _ = ex.step(key, ex.consts(snr), 0)
    return two_phase_trip_model(block.conv_iter.cpu().numpy(),
                                block.ok.cpu().numpy(), PHASE1, 12,
                                lanes=ex.lanes)


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--snrs", default=",".join(str(s) for s in SNRS))
    ap.add_argument("--batches", type=int, default=160,
                    help="batches of BATCH frames per timed window")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--out", default="build/two_phase_envelope")
    args = ap.parse_args(argv)

    from ldpc_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()

    from ldpc_tpu_torch.bench import measure_point
    from ldpc_tpu_torch.scripts.study import device_label, floats
    from ldpc_tpu_torch.sim.runner import derive_key, load_code
    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    code = load_code("builtin:wimax_1152_0.5.alist.txt")
    batch, n_batches, n_windows = BATCH, args.batches, args.windows
    execs = envelope_executors(code, batch, dev)
    report = {
        "device": device_label(dev),
        "code": code.name,
        "schedule": "layered",
        "iterations": 12,
        "batch": batch,
        "batches_per_window": n_batches,
        "windows": n_windows,
        "lanes": execs["off"].lanes,
        "points": [],
    }
    frame_bits = n_batches * batch * code.k
    for i, snr in enumerate(floats(args.snrs)):
        row = {"snr_db": snr}
        for tp, ex in execs.items():
            # the probe runs in measure_point's warm-up, as in production
            med, wins, fer, bits = measure_point(
                ex, code, snr, batch=batch, n_batches=n_batches,
                n_windows=n_windows, key=17 + i,
            )
            row[tp] = {
                "info_bits_per_s_med": bits,
                "info_bits_per_s_min": frame_bits / wins[-1],
                "info_bits_per_s_max": frame_bits / wins[0],
                "fer": fer,
                "kernel": ex.kernel_used,
            }
            print(f"snr={snr:g} two_phase={tp:4s} {bits / 1e9:.3f} G bits/s "
                  f"FER={fer:.2e} kernel={ex.kernel_used}", flush=True)
        probe = execs["auto"].last_probe
        row["auto_probe"] = {k: probe.get(k) for k in
                             ("overhead_us", "overhead_trips", "trip_us")}
        m = trip_model_of(execs["off"], snr, derive_key(99, i))
        row["trip_model"] = m
        t_ratio = (row["off"]["info_bits_per_s_med"]
                   / row["6"]["info_bits_per_s_med"])
        row["implied_overhead_trips"] = (
            m["single"] * t_ratio - (m["phase1_mean"] + m["phase2_per_tile"])
        )
        row["auto_vs_off"] = (row["auto"]["info_bits_per_s_med"]
                              / row["off"]["info_bits_per_s_med"])
        row["forced_vs_off"] = (row["6"]["info_bits_per_s_med"]
                                / row["off"]["info_bits_per_s_med"])
        row["fer_equal"] = len({row[tp]["fer"] for tp in MODES}) == 1
        print(f"  model={m} implied_overhead={row['implied_overhead_trips']:.2f} "
              f"auto probe={row['auto_probe']} "
              f"auto/off={row['auto_vs_off']:.3f} "
              f"forced/off={row['forced_vs_off']:.3f} "
              f"fer_equal={row['fer_equal']}", flush=True)
        report["points"].append(row)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "results.json").write_text(json.dumps(report, indent=1))
    unequal = [r["snr_db"] for r in report["points"] if not r["fer_equal"]]
    print(f"wrote {out}/results.json; FER unequal across modes at {unequal}")
    return 1 if unequal else 0


if __name__ == "__main__":
    raise SystemExit(main())
