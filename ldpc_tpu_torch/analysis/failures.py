"""Failure-structure profiling: error-weight histograms of failing frames.

Counterpart of ``ldpc_tpu/analysis/failures.py``. The simulation pipeline
reduces each batch to scalar counters; this module keeps one more moment of
the failure distribution -- a histogram over the *info-bit error weight* of
every frame the decoder got wrong -- accumulated on the device
(``index_add_``) over a chunk of the executor's steps, with one host fetch
per chunk, split:

* **detected** failures (syndrome check fails): the weight structure
  separates near-codeword / trapping-set events (small, repeatable weights,
  the error-floor mechanism) from channel noise overwhelming the decoder
  (weights near the uncoded error mass). Weight 0 is possible: all info
  bits right, residual errors confined to parity positions.
* **undetected** errors (syndrome passes, info bits wrong): the decoder
  converged to a DIFFERENT codeword; weights are bounded below by the
  minimum distance projected on the info positions. The reference's
  failed-frames-only BER accounting scores these frames as error-free
  (main.py:124-146) -- this profile measures what that convention hides.

The steps are the executor's own, so a fused executor profiles through K1
(and K2 on a split) and an unfused one through K3 or the plain decoders.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def make_profiler(executor, k_active: int):
    """On-device failure-weight histograms over a chunk of MC steps.

    Returns ``chunk(key_point, start, consts, n_steps) -> (hist_detected,
    hist_undetected, frames)``: int64 [k_active+1] device tensors of counts
    over info-bit error weight and the frames decoded. Batch ``start + i``
    draws from ``derive_key(key_point, start + i)`` as
    ``PointExecutor.run_point`` does, so (for the same point index) the
    profiled stream IS the stream a normal run at this point would decode.
    Works with fused and unfused executors; requires exact_ber=True, without
    which the undetected-error histogram would be silently empty.
    """
    from ldpc_tpu_torch.sim.runner import derive_key

    if not executor.opts.exact_ber:
        raise ValueError(
            "failure profiling needs exact_ber=True: without it the "
            "undetected-error histogram is silently empty "
            "(metrics.block_stats zeroes error bits of accepted frames)"
        )
    nbins = k_active + 1
    dev = executor.device

    def chunk(key_point: int, start: int, consts, n_steps: int):
        hd = torch.zeros(nbins, dtype=torch.int64, device=dev)
        hu = torch.zeros(nbins, dtype=torch.int64, device=dev)
        frames = 0
        for i in range(n_steps):
            stats, _ = executor.step(derive_key(key_point, start + i), consts)
            w = stats.error_bits.clamp(0, k_active).to(torch.int64)
            hd.index_add_(0, w, (~stats.ok).to(torch.int64))
            hu.index_add_(0, w, (stats.ok & (stats.error_bits > 0))
                          .to(torch.int64))
            frames += stats.ok.shape[0]
        return hd, hu, frames

    return chunk


def profile_point(code, opts, snr_db: float, min_failures: int,
                  max_blocks: int, say=print, executor=None,
                  point_index: int = 0, device=None):
    """Decode until ``min_failures`` detected failures (or ``max_blocks``
    frames), histogramming failure weights on the device.

    ``opts`` must carry ``exact_ber=True``; see :func:`make_profiler`. Pass
    ``executor`` to reuse one executor across SNR points and
    ``point_index`` (the point's index in the sweep grid) to profile the
    exact frame stream ``run_point`` would decode at that point. Returns
    ``(hist_detected, hist_undetected, frames)`` as numpy arrays / int.
    ``device=None`` means the card.
    """
    from ldpc_tpu_torch.sim.runner import PointExecutor, derive_key

    ex = executor if executor is not None else PointExecutor(
        code, opts, device=device)
    prof = getattr(ex, "_failure_profiler", None)
    if prof is None:
        prof = ex._failure_profiler = make_profiler(ex, ex.k_active)
    opts = opts.resolved()
    consts = ex.consts(snr_db)
    key_point = derive_key(opts.seed, point_index)
    hd = np.zeros(ex.k_active + 1)
    hu = np.zeros(ex.k_active + 1)
    frames = 0
    start = 0
    n_steps = 8
    t0 = time.time()
    while hd.sum() < min_failures and frames < max_blocks:
        d, u, f = prof(key_point, start, consts, n_steps)
        hd += d.cpu().numpy()  # one fetch a chunk
        hu += u.cpu().numpy()
        frames += f
        start += n_steps
        n_steps = min(n_steps * 2, 64)  # grow groups as the point gets deep
    say(
        f"  profiled {frames:,} frames in {time.time() - t0:.1f}s: "
        f"{int(hd.sum())} detected failures, {int(hu.sum())} undetected"
    )
    return hd, hu, frames


def make_pattern_profiler(executor, max_patterns: int = 256,
                          kind: str = "detected"):
    """Residual error vectors of failing frames over a chunk of MC steps.

    Returns ``chunk(key_point, start, consts, n_steps) -> (buf, count)``:
    ``buf`` is a uint8 [max_patterns, n] device tensor holding the first
    ``max_patterns`` residuals e = est XOR w of the selected frames, in
    batch order; ``count`` (a device scalar) is the total number seen (may
    exceed the buffer). ``kind``:

    * ``'detected'`` -- syndrome check failed: H@e = H@est != 0 (w is a
      valid codeword); supports are trapping-set candidates.
    * ``'undetected'`` -- syndrome passed but info bits are wrong: the
      residual is itself a NONZERO CODEWORD (H@e = 0), so every captured
      pattern's weight is an upper bound on the code's minimum distance.
      Requires exact_ber=True.

    The buffer is filled on the device (rows past it go to a discarded
    row), so the host fetches one [K, n] buffer per chunk. Requires an
    unfused executor (fused='off').
    """
    from ldpc_tpu_torch.sim.runner import derive_key

    if kind not in ("detected", "undetected"):
        raise ValueError(f"kind must be 'detected' or 'undetected': {kind!r}")
    if kind == "undetected" and not executor.opts.exact_ber:
        raise ValueError(
            "undetected-error capture needs exact_ber=True: without it "
            "error_bits is zeroed for syndrome-passing frames"
        )
    if executor.fused:
        raise ValueError(
            "pattern capture needs the unfused pipeline: build the "
            "PointExecutor with fused='off'"
        )
    K = max_patterns
    n = executor.code.n
    dev = executor.device

    def chunk(key_point: int, start: int, consts, n_steps: int):
        buf = torch.zeros((K + 1, n), dtype=torch.uint8, device=dev)
        cnt = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(n_steps):
            stats, _, resid = executor.pattern_step(
                derive_key(key_point, start + i), consts)
            if kind == "detected":
                failed = ~stats.ok
            else:
                failed = stats.ok & (stats.error_bits > 0)
            pos = cnt + torch.cumsum(failed.to(torch.int64), 0) - 1
            keep = failed & (pos < K)
            buf.index_copy_(0, torch.where(keep, pos, K), resid)
            cnt = cnt + failed.sum()
        return buf[:K], cnt

    return chunk


def collect_failure_patterns(code, opts, snr_db: float, min_patterns: int,
                             max_blocks: int, max_patterns: int = 256,
                             say=print, executor=None, point_index: int = 0,
                             kind: str = "detected", device=None):
    """Residual error vectors of failing frames at one SNR point.

    Returns ``(patterns, failures_seen, frames)`` with ``patterns`` a uint8
    [min(failures_seen, max_patterns), n] numpy array. ``executor`` /
    ``point_index`` as in :func:`profile_point`; ``kind`` as in
    :func:`make_pattern_profiler`.
    """
    from ldpc_tpu_torch.sim.runner import PointExecutor, derive_key

    ex = executor if executor is not None else PointExecutor(
        code, opts, device=device)
    cache = getattr(ex, "_pattern_profilers", None)
    if cache is None:
        cache = ex._pattern_profilers = {}
    prof = cache.get((max_patterns, kind))
    if prof is None:
        prof = cache[(max_patterns, kind)] = make_pattern_profiler(
            ex, max_patterns, kind
        )
    opts = opts.resolved()
    consts = ex.consts(snr_db)
    key_point = derive_key(opts.seed, point_index)
    buf = np.zeros((max_patterns, code.n), np.uint8)
    seen = 0
    frames = 0
    start = 0
    n_steps = 8
    t0 = time.time()
    while seen < min(min_patterns, max_patterns) and frames < max_blocks:
        # each chunk restarts an empty device buffer; copy the fresh rows out
        b, c = prof(key_point, start, consts, n_steps)
        c = int(c)
        room = max_patterns - seen
        fresh = b[: min(c, room)].cpu().numpy()
        buf[seen: seen + len(fresh)] = fresh
        seen += c
        frames += n_steps * ex.batch
        start += n_steps
        n_steps = min(n_steps * 2, 64)
    say(
        f"  captured {min(seen, max_patterns)} failure patterns "
        f"({seen} failures / {frames:,} frames) in {time.time() - t0:.1f}s"
    )
    return buf[: min(seen, max_patterns)], seen, frames


def trapping_census(patterns: np.ndarray, code, graph: str = "orig",
                    top: int = 10) -> dict:
    """Classify residual error vectors into (a, b) trapping-set classes.

    ``a`` = residual support size (variable nodes in error), ``b`` = number
    of unsatisfied checks (weight of H @ e mod 2). Small recurring (a, b)
    classes with b << a*dv are near-codeword / trapping-set events -- the
    error-floor mechanism; ``classes`` maps "a,b" -> count (all classes,
    most frequent first) and ``recurring_supports`` lists the ``top`` exact
    supports captured more than once.
    """
    H = (code._h_std_dense if graph in ("std", "standard")
         else code.H.to_dense()).astype(np.int64)
    classes: dict[str, int] = {}
    supports: dict[tuple, int] = {}
    for e in np.asarray(patterns):
        sup = np.flatnonzero(e)
        if sup.size == 0:
            continue  # not a detected failure (defensive)
        b = int((H[:, sup].sum(axis=1) & 1).sum())
        key = f"{sup.size},{b}"
        classes[key] = classes.get(key, 0) + 1
        skey = tuple(int(v) for v in sup)
        supports[skey] = supports.get(skey, 0) + 1
    recurring = sorted(
        ((list(s), c) for s, c in supports.items() if c > 1),
        key=lambda sc: -sc[1],
    )[:top]
    return {
        "patterns": int(len(patterns)),
        "classes": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
        "recurring_supports": [
            {"support": s, "count": c, "a": len(s)} for s, c in recurring
        ],
    }


def profile_sweep(code, opts, snrs, min_failures: int, max_blocks: int,
                  say=print, device=None) -> dict:
    """Failure profile at each SNR in ``snrs`` with ONE executor.

    Returns ``{snr: {frames, detected, undetected, hist_detected,
    hist_undetected}}`` (JSON-ready; histograms as weight->count dicts).
    Used by the CLI's ``--failure-profile``.
    """
    from ldpc_tpu_torch.sim.runner import PointExecutor

    ex = PointExecutor(code, opts, device=device)
    out = {}
    for idx, snr in enumerate(snrs):
        say(f"profiling failures at {snr:g} dB")
        hd, hu, frames = profile_point(
            code, opts, snr, min_failures, max_blocks, say=say, executor=ex,
            point_index=idx,
        )
        out[snr] = {
            "frames": frames,
            "detected": weight_summary(hd),
            "undetected": weight_summary(hu),
            "hist_detected": {int(w): int(c) for w, c in enumerate(hd) if c},
            "hist_undetected": {int(w): int(c) for w, c in enumerate(hu) if c},
        }
    return out


def weight_summary(hist: np.ndarray) -> dict:
    """Percentile summary of a weight histogram (counts indexed by weight)."""
    total = hist.sum()
    if total == 0:
        return {"count": 0}
    w = np.arange(hist.size)
    cum = np.cumsum(hist)

    def pct(q):
        return int(w[np.searchsorted(cum, q * total)])

    return {
        "count": int(total),
        "min_weight": int(w[hist > 0][0]),
        "max_weight": int(w[hist > 0][-1]),
        "p10": pct(0.10),
        "median": pct(0.50),
        "p90": pct(0.90),
        "mean": float((hist * w).sum() / total),
    }
