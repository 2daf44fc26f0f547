"""Headline benchmark of the port: Monte-Carlo throughput on WiMAX (1152, 576).

Counterpart of the JAX package's ``bench.py`` (``measure_point``,
``measure_paired`` / ``paired_ratio`` and the JSON line, ``bench.py:40-119,
122-227``) on one GPU. It times the production streaming path,
``PointExecutor.run_point``: info bits, the encode product,
the fused Monte-Carlo kernel, two-phase compaction and the LLR kernel, and
the counters, at Eb/N0 2 dB (``speed=0.5``, exact noise, the original
Tanner graph), layered SPA at 12 iterations, paired layers, a syndrome check
every two sweeps, 4096 frames per batch.

Run on the card: ``python -m ldpc_tpu_torch.bench [--two-phase auto|off|N]``.
Warm-up runs first, then ``--windows`` timed windows of ``--batches``
batches each; the value is the median window's decoded info bits/s. The
other windows, FER, the dispatch choice, the card's name and its power limit
go to stderr, and after the timed windows a ``torch.profiler`` trace of 16
batches gives the device's busy and idle share and its time by kernel
(:func:`device_breakdown`). Prints ONE JSON line on stdout.

``--roofline PATH`` reads a ``roofline.json`` of ``python -m
ldpc_tpu_torch.scripts.roofline`` and adds ``pct_of_ceiling`` to the stderr
line when that report priced this run's dispatch mode and syndrome cadence
(:func:`matching_ceiling`, the JAX bench's rule, ``bench.py:169-206``); else
it says why it omits it. The stdout line keeps its keys.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

BASELINE_INFO_BITS_PER_S = 363.0  # the reference simulator (BASELINE.md)


def measure_point(executor, code, snr_db, *, batch, n_batches, n_windows,
                  warmup_batches=64, warmup_runs=2, key=0):
    """Median-window throughput and FER at one SNR point.

    ``warmup_runs`` untimed ``run_point`` calls (kernel build, first
    launches, the two-phase probe), then ``n_windows`` timed windows of
    ``n_batches`` batches, each ending in the point's one host fetch.

    Returns ``(median_s, sorted_window_times, fer, info_bits_per_s)``.
    """
    for w in range(warmup_runs):
        executor.run_point(snr_db, batch * warmup_batches, key + 999 + w, w)
    codewords = n_batches * batch
    window_times, fer_frames = [], 0
    for w in range(n_windows):
        t0 = time.perf_counter()
        s = executor.run_point(snr_db, codewords, key + w, w)
        window_times.append(time.perf_counter() - t0)
        fer_frames += s.fer_frames
    window_times.sort()
    median = window_times[len(window_times) // 2]
    fer = fer_frames / (n_windows * codewords)
    return median, window_times, fer, codewords * code.k / median


def measure_paired(configs, *, batch, n_batches, n_rounds=5,
                   warmup_batches=None, key=0):
    """Paired A/B window timing: every config's timed windows interleaved
    within one process (``bench.py:73-105`` of the JAX package).

    ``configs``: list of ``(label, executor, snr_db)``. One untimed
    ``run_point`` per config first (key ``key + 7000 + i``), then
    ``n_rounds`` rounds of one timed window per config back to back (key
    ``key + r * 97 + i``), so a per-round ratio compares windows timed
    seconds apart: drift of the host's load moves both, and a stall hits one
    window of one round.

    Returns ``{label: [t_round0, t_round1, ...]}`` in round order (not
    sorted: the pairing is positional)."""
    if warmup_batches is None:
        warmup_batches = n_batches
    for i, (label, ex, snr) in enumerate(configs):
        ex.run_point(snr, batch * warmup_batches, key + 7000 + i, 0)
    times = {label: [] for label, _, _ in configs}
    for r in range(n_rounds):
        for i, (label, ex, snr) in enumerate(configs):
            t0 = time.perf_counter()
            ex.run_point(snr, batch * n_batches, key + r * 97 + i, r)
            times[label].append(time.perf_counter() - t0)
    return times


def paired_ratio(times_a, times_b):
    """Median per-round ratio t_a / t_b with the middle-round spread.

    Returns ``(median, lo, hi)`` over the per-round ratios (one outlier
    round dropped per side at 4 rounds or more)."""
    import numpy as np

    r = np.sort(np.asarray(times_a) / np.asarray(times_b))
    med = float(np.median(r))
    if len(r) >= 4:
        return med, float(r[1]), float(r[-2])
    return med, float(r[0]), float(r[-1])


def device_breakdown(executor, snr_db, *, batch, n_batches=16, key=7777):
    """Device time by kernel over ``n_batches`` batches of ``run_point``,
    from a ``torch.profiler`` trace taken after a warm run of the same
    batches. Returns ``(span_ms, busy_ms, [(name, ms, calls), ...])``: the
    span from the first device event's start to the last one's end, the
    union of the device events' intervals, and the kernels by total time.
    ``span_ms`` is None when the trace holds no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    executor.run_point(snr_db, batch * n_batches, key, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        executor.run_point(snr_db, batch * n_batches, key, 0)
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (t1 - t0) / 1e3, calls + 1)
    if not spans:
        return None, None, []
    spans.sort()
    busy, cur0, cur1 = 0.0, *spans[0]
    for t0, t1 in spans[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    span = spans[-1][1] - spans[0][0]
    top = sorted(((n, ms, c) for n, (ms, c) in by_name.items()),
                 key=lambda x: -x[1])
    return span / 1e3, busy / 1e3, top


def matching_ceiling(roof: dict, kernel_used: str,
                     check_every: int) -> tuple[float | None, str]:
    """(ceiling info bits/s, "") when ``roof`` prices this run, else
    (None, why). A two-phase op stream has its own ceiling, and the syndrome
    cadence changes the ops per sweep, so both must match; the layer order
    only reorders the same ops."""
    from ldpc_tpu_torch.scripts.roofline import TWO_PHASE_RAN

    used_two_phase = bool(TWO_PHASE_RAN.search(kernel_used))
    if roof.get("two_phase_ceiling", False) != used_two_phase:
        return None, (f"roofline.json prices kernel={roof.get('kernel')!r} "
                      f"but this run used {kernel_used!r}")
    if roof.get("check_every", 1) != check_every:
        return None, (f"roofline.json prices check_every="
                      f"{roof.get('check_every', 1)}, this run {check_every}")
    return roof["ceiling_info_bits_per_s"], ""


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--two-phase", default="auto",
                    help="'auto' (the default), 'off', or phase-1 iterations")
    ap.add_argument("--batches", type=int, default=320,
                    help="batches of 4096 frames per timed window")
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--roofline", metavar="PATH",
                    help="roofline.json to quote pct_of_ceiling from")
    args = ap.parse_args(argv)

    import torch

    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code

    if not torch.cuda.is_available():
        print("bench: CUDA is not available", file=sys.stderr)
        return 2
    code = load_code("builtin:wimax_1152_0.5.alist.txt")
    batch = 4096
    opts = SimOptions(
        matrix=code.name, blocks=batch, iterations=12, ber=True, fer=True,
        fidelity="exact", batch=batch, seed=0, speed=0.5, schedule="layered",
        layer_order="paired", check_every=2, two_phase=args.two_phase,
    )
    executor = PointExecutor(code, opts)
    elapsed, window_times, fer, bits_per_s = measure_point(
        executor, code, 2.0, batch=batch, n_batches=args.batches,
        n_windows=args.windows,
    )
    codewords = args.batches * batch
    info_bits = codewords * code.k
    rates = [info_bits / t for t in window_times]
    sol = ""
    if args.roofline:
        with open(args.roofline, encoding="utf-8") as f:
            ceiling, why = matching_ceiling(json.load(f), executor.kernel_used,
                                            opts.check_every)
        if ceiling:
            sol = f" pct_of_ceiling={100 * bits_per_s / ceiling:.2f}%"
        else:
            print(f"# {why}; omitting pct_of_ceiling (re-run python -m "
                  "ldpc_tpu_torch.scripts.roofline)", file=sys.stderr)
    print(
        f"# code={code.name} n={code.n} k={code.k} batch={batch} "
        f"kernel={executor.kernel_used} codewords/window={codewords} "
        f"median_window={elapsed:.4f}s windows_s={window_times} "
        f"bits/s min/med/max={min(rates):.6g}/{bits_per_s:.6g}/{max(rates):.6g} "
        f"FER@2dB={fer:.6f} probe={executor.last_probe} "
        f"card={card_line()!r}{sol}",
        file=sys.stderr,
    )
    span, busy, top = device_breakdown(executor, 2.0, batch=batch)
    if span is None:
        print("# profile: the trace holds no device events", file=sys.stderr)
    else:
        print(f"# profile: 16 batches, device span {span:.4f} ms, busy "
              f"{busy:.4f} ms ({100 * busy / span:.2f}%), idle "
              f"{100 * (1 - busy / span):.2f}%", file=sys.stderr)
        for name, ms, calls in top[:12]:
            print(f"#   {ms:10.4f} ms {100 * ms / busy:6.2f}% {calls:5d}x "
                  f"{name[:100]}", file=sys.stderr)
    print(json.dumps({
        "metric": "wimax_1152_576 full-pipeline decoded info bits/s/chip",
        "value": round(bits_per_s, 1),
        "unit": "info_bits/s",
        "vs_baseline": round(bits_per_s / BASELINE_INFO_BITS_PER_S, 1),
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
