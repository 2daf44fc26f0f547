#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``ldpc_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Every phase is
fatal: the script exits nonzero, and prints no result line, when CUDA is
missing, a kernel does not build or launch, a kernel disagrees with its
plain PyTorch version, or the main path gives a wrong answer.

Phases:

1. CUDA present; the card's name and power limit (``nvidia-smi``).
2. Build the kernels from ``ldpc_tpu_torch/csrc`` (one ``nvcc`` per source,
   started together: K1, K2 and K3 one source each over
   ``decode_group.cuh``, and the roofline probes) and print the build time;
   then one line with the registers, barriers and spill bytes ``ptxas``
   reports for each of the 78 decode-kernel instantiations (K1, K2 and K3
   at row degrees 8 / 16 / 32 x layered / flooding x with / without the
   flip metric x f32 / int8 E, and K1's refill at the three row degrees x
   f32 / int8 E), failing if a DMAX=8 instantiation spills or takes more
   than 80 registers.
3. Hold each kernel against its plain version on the card, at the main
   path's shapes (WiMAX (1152, 576), 4096 frames, paired layers, a syndrome
   check every two sweeps), for normalized min-sum and SPA:
   * K1 ``mc_decoder`` (6 iterations, LLRs emitted), once with injected
     noise words and once with in-kernel Philox against the plain version's
     Philox words (``philox_raw``): the emitted LLRs to the channel bar
     (rtol 1e-5, atol 1e-4); for min-sum, ok / conv / err / iters equal for
     every frame to the plain decode of the kernel's own LLRs (min-sum is
     exact arithmetic once the LLRs agree); for SPA, the same counters equal
     on >= 99% of frames against the plain version (tanh and log differ by
     ulps between implementations);
   * K2 ``llr_decoder`` (12 iterations) from K1's LLRs with a random pre-done
     mask: the same bars.
   Then the same checks at 512 frames for every configuration of the
   kernels that the main path does not run (``COVERAGE``): multi-diagonal
   layers (CCSDS), the 16 and 32 row-degree instantiations, min-sum and
   offset min-sum, channel modes 2 and 3, the QPSK proxy, serial layers,
   check every 1 and 3, and the block plans: 8 and 2 codewords sharing one
   warp (Z = 4 and 16), padding threads (48 and 27 threads per codeword),
   one codeword of 192, 384 and 768 threads (Z = 96, 192, 384); flooding
   with and without the flip metric (the flip metric equal too), 4
   codewords sharing a warp, n=4608 and n=9216; int8 E on multi-diagonal and paired layers and under
   flooding; a [T, D] and a [T] alpha schedule.
   3b. K1's refill (codewords sharing a warp, one pass of the layered
   schedule; ``phase_refill``): CCSDS n=128 (2 codewords a warp) and n=32
   (8), SPA and normalized min-sum, 1.5 and 3.0 dB, injected words and
   Philox, at a batch within one wave and one over the card's grid and no
   multiple of its lane groups: against the plain version and against the
   same decoder launched block per group (``hold_refill``); then the cell's K1 timed at 131,072 frames, refill
   against block per group, with its bound.
4. The main path: ``PointExecutor`` at the settings of the headline bench
   (layered SPA, 12 iterations, paired, check every 2) through
   ``run_point(2.0, ...)`` for 64 batches of 4096 frames, twice: with
   two-phase ``auto`` (the probe may choose a single pass) and with the
   split forced at 6 phase-1 iterations (phase 2 is ``llr_decoder``). The
   launch counts are zeroed just before each run and read just after; each
   run must launch the kernels its dispatch uses, both kernels must have
   launched, and K7, its add and K8 must each launch once a batch of the
   run's ``batches`` counter (the ``kernels`` line's K7 and K8 counts). The two runs draw the same frames, and the decode works
   lane by lane, so their counters must be equal. FER must lie within 5
   standard errors of 0.0065, the JAX package's FER at this point
   (``BENCH_r04.json``), used as a statistic of the code, not as a speed.
   4b. The fused flooding path (the CLI's default schedule): flooding
   SPA-16 at 2.0 dB, 64 batches, a single pass and the split forced at 8,
   the counts zeroed before each and read after (K1 in both, K2 in the
   split, K3 never); equal counters; FER within 5 combined standard errors
   of ``examples/decoder_variants/sumproduct.json`` (225 / 8,192).
5. The main path's own kernel calls (SPA, Philox noise): ``mc_decoder`` as
   ``auto`` launches it at this point (12 iterations, one pass) and as
   phase 1 of a split, ``llr_decoder`` on that phase 1's compacted output,
   each held against its plain version on the same inputs (the bars of
   phase 3), then timed with CUDA events beside its plain version and its
   bound: the larger of its operations over the card's issue peak (one f32
   instruction per lane per clock, ``issue_peak_ops_per_s``) and its bytes
   over 3.35 TB/s. The operations are the roofline census
   (``analysis.roofline.decode_census`` / ``channel_census``) scaled by
   each lane's sweeps through its converging check window. The ``kernels``
   line carries the single pass for ``mc_decoder``; its ``max_abs_err`` is
   the largest error of phases 3 (main shapes) and 5. Then the block plans
   of both kernels with their resident blocks per SM.
   5b. The decoders' options held against their plain versions
   and timed beside them, their bounds and blocks per SM: K1 flooding
   SPA-16 with and without the flip metric; K2 flooding on a forced split;
   K1 layered paired
   NMS-12 ce2 with a scalar, a [T] and a [T, D] alpha; K3 flooding NMS-16
   with f32 and int8 E at WiMAX 1152 and n=9216.
6. K3 ``qc_decoder`` (the standalone QC decoder of the unfused path)
   against its plain version at wimax 1152, 4096 frames, on channel LLRs
   made on the card: flooding SPA-16 with the normalized-LLR metric on and
   off, layered SPA-12 serial, layered SPA-12 paired with a check every two
   sweeps, flooding normalized min-sum; decisions, ok, conv, norm and the
   block trip counts must be equal bit for bit. Then ``QC_COVERAGE`` at 512
   frames: CCSDS n32 flooding and layered (multi-diagonal; 4 and 8
   codewords sharing a warp), row degrees 15, 20 and 22, ``skip=1``, n=4608
   and n=9216 under flooding (384 and 768 threads), n=9216 layered paired
   SPA-12 with a check every two sweeps, and 16-QAM mode-2 LLRs as input.
   6b. K6 ``qam_channel`` (the unfused path's Gray-QAM channel in one
   kernel) against its plain version, the interleave -> channel ->
   deinterleave chain, at 4096 frames of wimax 1152 and 576 codewords, for
   channel modes 1-3 x QPSK / 16-QAM / 64-QAM x interleaver none / regular /
   random, both sides from generators of the same seeds: the LLRs equal bit
   for bit, one launch a call; its ``ptxas`` line; then K6 timed at the
   16-QAM mode-2 random configuration beside its bound by bytes, the
   wrapper's whole call (draws and argsort) and the plain chain.
   6c. K7 ``batch_counters`` (a batch's counters and their add into the
   float64 totals) against its plain version at 4096 and 131,072 frames:
   every row, a partial ``take`` at a shard's row offset ``lo`` > 0, no
   row, ``iters`` [B] and [1], arrays misaligned for its vector loads; the
   integer slots equal, the norm slot bit-equal over two launches and
   within 1e-6 relative of the plain f32 sum; the add equal to the plain
   add. Then ``run_point`` on the main configuration: ``BATCH_COUNTERS``
   and ``ADD_COUNTERS`` launch once a batch, the probe's included, and the
   point's counters equal a run through the plain reduction. Then K7 timed
   with CUDA events (launches queued behind a device sleep, so that the card
   runs them back to back) beside its bound by bytes, and the host's time a
   batch to enqueue both launches against the plain operators'.
   6d. K8 ``gf2_encode`` (the GF(2) encode in one kernel) against its plain
   version, the f32 product mod 2 it replaced, bit for bit: wimax 1152 at
   4096 frames in both layouts ([n, B] for K1 / K2, [B, n] for the unfused
   path) and both graphs; CCSDS (128, 64) at 131,072 frames; a ragged slice at a shard's
   row offset; info bits misaligned for its 16-byte loads; ITU-T G.hn
   (336, 168), whose k is not a multiple of 32; a random code of k = 1100
   (two word tiles). Its ``ptxas`` line. Then ``ENCODE.launches`` equals the
   ``batches`` counter of a fused and of an unfused ``run_point``, the
   probe's batch included. Then K8 timed with CUDA events (20 launches
   queued behind a device sleep) beside its bound by bytes and by
   operations (each priced at its pipe) and its plain version, the f32 GEMM
   + cast + remainder (``plain_ms`` and ``library_ms``).
7. The unfused path through ``run_simulation``: the burst-interleaver
   configuration at wimax 1152 (16-QAM, mode-2 jamming p 0.15 at -3 dB,
   random interleaver, layered SPA-12), 3 SNR points (5.0, 5.5, 6.0 dB) x 16
   batches of 4096; its JSON written and read back; K3, K6, K7 and K7's
   add must launch once per batch and K1 / K2 never. Then the CLI's default schedule, flooding SPA-16,
   BPSK, at 2.0 dB over 64 batches, through K3 (``fused='off'``: K3 once
   per batch) and through the fused kernels (``auto``, then ``--two-phase
   off``: K1, never K3), each with its info bits/s; then where the time of
   the two routes goes: for K3, fused ``off`` and fused ``auto``, the
   ``PointExecutor`` set-up, a first ``run_point`` of 64 batches (``auto``'s
   probe included) and a second one on the same executor.
8. FER against the JAX package's TPU records, as statistics of the code:
   the flooding run of phase 7 against ``examples/decoder_variants/
   sumproduct.json`` (225 / 8,192 at 2.0 dB), and the burst configuration at
   wimax 576, 6.0 dB, 16 batches, against ``examples/burst_interleaver/
   results.json`` (``random``: 801 / 14,336); each within 5 combined
   standard errors. 8b. The fused kernels' new configurations against their
   records: the learned [T] schedule through fused flooding NMS-12 at wimax
   576, 2.0 dB (``examples/learned_minsum/results.json``: 0.15137 of
   40,960; the scalar 0.75 gives 0.19700) and int8 E through fused flooding
   NMS-20 at wimax 1152, 2.0 dB (``examples/quantized_messages/RESULTS.md``
   ``nms-int8msg``: 3.208e-02 of 40,000), 16 batches each, within 5
   combined standard errors.
9. K3 timed with CUDA events at 4096 frames (flooding SPA-16 at the phase-7
   flooding point, layered SPA-12 at the headline's 5.5 dB point) beside its
   plain version and its bound (the census of the data's sweeps over the
   issue peak, and the LLRs in plus the decisions out over 3.35 TB/s), with
   its block plan and resident blocks per SM; then one ``torch.profiler``
   window of 16 unfused headline batches at 5.5 dB: K3's device ms per batch
   against the rest of the batch's device time, the batch's device busy
   time and its host time without the profiler.
10. The roofline path (K4 ``rate_chain``, K5 ``mix_rate``): every K4 op
   class against its plain version at depth 64 on the card full of
   256-thread blocks (roll and prng bit for bit, the rest within rtol
   1e-6); then, with the launch counts zeroed just before and read just
   after, ``python -m ldpc_tpu_torch.scripts.roofline`` (the nine rates, the
   trips at the bench point, both ceilings, the bench cut to 64 batches per
   window) and ``...scripts.attainable_ceiling`` (the K5 stream ladder
   1-16 at full occupancy and at K1's launch shape) into a temporary
   directory; their reports checked (finite, the trip model's ``single``
   equal to the readback, achieved below its ceiling, FER within 5 sigma);
   every ladder entry against its plain version (rtol 1e-6); K4 (fma, depth
   4096) and K5 (8 streams, 64 passes) timed beside their plain versions
   and bounds: each hot loop's SASS sorted by pipe (a table per library),
   priced by ``ops.rate_kernels.pipe_bound`` (the larger of the issue term
   and each pipe's term at compute capability 9.0's rates), with the pipe
   that sets the bound and the census bound beside it. K1-K3's "attainable
   ms" prices their census at the measured K5 rate.
11. Only with ``--fer-batches N``: the FER at the headline point, single
   pass, paired and serial, with the in-kernel Philox noise and with words
   drawn by ``torch.randint``, N batches of 4096 frames each.
12. The CLI's default path and the plain PyTorch decoders (no kernel of
   theirs; K1-K3 must not launch where they run):
   12a. ``python -m ldpc_tpu_torch.cli`` in this process at ``--fidelity
   reference`` (std graph, legacy rule and noise), wimax 576, SPA-5, 3.5 dB,
   102,400 frames: FER within 5 combined standard errors of the TPU record
   (``parity_runs/ours_deep.json``: 962 / 400,000), info bits/s and peak
   memory. 12b. The adaptive sweep of ``examples/wimax576_adaptive`` (0-5 dB,
   20,000 frames a point): the adaptation log equal to the record's, each
   FER within 5 combined standard errors. 12c. One point each through
   ``run_simulation``: the Richardson-Urbanke encoder (FER within 5 sigma of
   12a's), bit-flipping, and ``--kernel xla --schedule layered`` paired
   normalized min-sum against the same point through K3 (equal counters).
   12d. Each plain decoder on the card against itself on the CPU, same LLRs,
   512 frames: min-sum and bit-flipping equal bit for bit, SPA equal on >=
   99% of frames. 12e. The plain decoders timed per batch at the CLI's
   auto batch (wimax 576 and 1152; std, orig, layered) with peak memory.
   12f. One ``torch.profiler`` window of two plain batches at wimax 576
   (reference fidelity, and ``--kernel xla`` flooding): device busy against
   the host clock, and the kernels by device time.
13. The parallel sweep, meshes and the analyses (``ldpc_tpu_torch.
   parallel``, ``analysis.{failures,importance,learned_minsum}``): 13a. K3
   over 4 points of the bench code in one launch (``sweep_step``): one
   launch, each point equal to its single-point step, a skip mask [1,0,1,0]
   (0 trips), bit-equal to its plain version, its ms against 4 single-point
   launches, beside its plain version's ms, its bound and its attainable ms
   (the census of the data's sweeps at the issue peak and at K5's rate).
   13b. K1 with the codeword offset: halves at b0 = 0 and B/2 bit-equal to
   the whole launch, and K1 timed beside a build of its source without the
   offset (the counter as it was before), in turns, with its plain ms,
   bound and attainable ms. 13c.
   ``run_simulation_parallel`` over wimax 576 at 2.0-2.75 dB, layered
   SPA-12, --exact-ber, --target-errors 100: one K3 launch per batch index,
   counters equal to ``run_simulation(fused='off')``, FER within 5 combined
   sigma of ``examples/error_floor/curve.json``, both runs' info bits/s.
   13d. Two ranks on the one card over gloo: a batch-mesh point (K1 with
   each rank's offset), an snr=2 mesh sweep and the CLI under
   ``--distributed --mesh batch=2``, counters equal to one process. 13e.
   ``--failure-profile`` at 3.5 dB to >= 100 detected failures against
   ``failure_profile.json`` (5 sigma), then a census of 128 patterns at the
   census record's 3.25 dB. 13f. ``estimate_point`` at 3.5 dB with the
   record's supports against ``importance/results.json`` (5 combined
   sigma). 13g. The learned [12] schedule through ``evaluate_alphas`` at
   2.5 dB over 40,960 frames against ``learned_minsum/results.json`` (5
   sigma), and 20 ``train_alphas`` steps that lower a held-out loss.
14. The repo-level studies (``ldpc_tpu_torch/scripts``) on the card at
   reduced counts, each with the launch counts zeroed just before it and
   read just after, into a temporary directory; each FER, rate and witness
   check within 5 combined standard errors of its TPU record, each output
   with no randomness equal to the record's: ``error_floor`` (the curve at
   2.0-2.5 dB to 50 frame errors through K1 against ``curve.json``, the
   failure profile at 3.0 dB through K3 against the curve's 3.0 dB point,
   the census classes of the census record's recurring supports);
   ``undetected_witness`` (wimax 576 at 2.5 dB: nonzero codewords of weight
   >= 13, the weight-13 ones in the orbit of the importance record's
   codeword supports, the event rate against 8 / 229,376);
   ``importance_floor`` (its own capture, the committed census, one
   validation point at 3.5 dB over the record's frames); the five
   message-precision variants at 2.0 and 2.5 dB, 4096 frames; the burst
   study at 5.75 dB, target 100, its adversarial permutation equal to the
   committed one; ``learned_minsum_study`` (20 steps, 4096 evaluation
   frames, the fixed-alpha columns); ``parity_fixed_noise`` (5 reps) and
   ``parity_spread`` (3 reps) against ``parity_runs``; the family
   validation's ``run_code`` on its ten layered representatives, layered and
   flooding, through K1; one perf-matrix cell and its ``row_ceiling``. A
   table of every comparison closes the phase.
15. The throughput studies (``ldpc_tpu_torch/scripts``) on the card at
   reduced counts, the launch counts zeroed just before each and read just
   after (K1 in every study, K2 in the forced splits, K3 in the S-random
   chain), into a temporary directory; each frame-error count within 5
   standard errors of its TPU record (:func:`five_se`): the atlas's
   ``code_rows`` on the record's first code of each of the 8 families,
   2,048 frames x 6 points, against ``atlas.csv``; both big-code ALISTs
   byte-equal to the committed ones, then the big-code study at n=4608
   (its load timed) with its shared-memory plan, a 16-batch perf window
   and its curves cut to 65,536 frames a point through K1 and through the
   S-random chain against ``examples/big_code``; the four MFU levers and
   the six decoder variants at 16 batches against their records; the
   two-phase envelope at 0 and 2 dB (FER equal across off / 6 / auto); one
   paired point (3.5 dB, 3 rounds); ``two_phase_parity.main`` whole (every
   counter equal, the norm-LLR gate); the small-code binder's ladder at
   4096 and 65536 frames a batch and its isolation at 64 steps (host and
   device us a step; it fails where the host did not queue every group of
   steps before its spin ended). A table of every comparison closes the
   phase.
16. The JAX repo's last entry points and its CLI-made records, the launch
   counts zeroed just before each step and read just after: 16a.
   ``ldpc_tpu_torch.entry.entry()`` on the card against the same decoder on
   the CPU (the plain flooding SPA-10 decoder, no kernel of K1-K3), on its
   own N(0, 1) LLRs and on 256 all-zero-codeword frames at 2.5 dB from a
   seeded ``torch.Generator`` (both outcomes occur): ``ok`` and
   ``conv_iter`` equal on every frame, ``est`` on >= 99% of frames. 16b.
   ``scripts.exit_charts.main``: both GA thresholds equal to
   ``examples/exit_charts/exit_thresholds.json``. 16c. The rate-1/2 DE
   threshold (``scripts.cli_records.de_rate``, seeds 0-2) within [min -
   0.08, max + 0.08] dB of the waterfall README's 0.84 dB. 16d.
   ``cli_records.hold_record`` on ``rate_0.5.json`` (five points, layered
   SPA-16) and the four decoder-variant records at 1.5-2.5 dB (flooding,
   16 iterations), ``--target-errors 50``, at most 65,536 frames a point,
   through the port's CLI: K1 launched and K3 never in each, each point
   within 5 combined standard errors of its record. 16e. A table of every
   comparison closes the phase.
17. One ``kernels`` JSON line, then the device line as the last line.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH = 4096
SNR_DB = 2.0
REF_FER = 0.0065  # BENCH_r04.json, paired + ce2, 2 dB (a code statistic)
MAIN_BATCHES = 64
PHASE1, ITERS, CHECK_EVERY = 6, 12, 2
CSRC = "ldpc_tpu_torch/csrc/"
ROOFLINE_SOURCE = CSRC + "roofline.cu"
ROOF_BENCH_BATCHES = 64  # batches per window of the roofline path's bench
COMPARE_DEPTH = 64  # K4 bodies when held against the plain version
K4_TIME_DEPTH, K5_TIME_PASSES, K5_TIME_STREAMS = 4096, 64, 8
W1152 = "builtin:wimax_1152_0.5.alist.txt"
QC_BATCHES = 16  # batches of 4096 per point of the unfused runs
FLOOD_BATCHES = 64
# the JAX package's TPU records (statistics of the code, not speeds)
REF_FLOOD = (225, 8192)  # examples/decoder_variants/sumproduct.json, 2.0 dB
REF_BURST = (801, 14336)  # examples/burst_interleaver/results.json, random, 6.0 dB
BURST = dict(modulation=16, mode=2, p=0.15, interference_snr=-3.0,
             interleaver="random", schedule="layered", decoder="sumproduct",
             iterations=12)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- bounds ----

def bound_ms(ops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """The least time of ``ops`` census operations (one instruction each) at
    the issue peak ``peak`` and ``nbytes`` at the HBM rate, and which binds."""
    from ldpc_tpu_torch.analysis.roofline import HBM_BYTES_PER_S

    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------------ timing ----

def time_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def time_queued_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls enqueued behind a
    device sleep, so that the card runs them back to back however long the
    host takes to enqueue each (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # about 50 ms at 1980 MHz
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


# -------------------------------------------------------------- comparisons ----

def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def frames_equal(a, b):
    """bool [B]: err, ok, conv, norm (the flip metric, an integer count over
    k, or zeros) and iters agree per frame."""
    err_a, ok_a, conv_a, norm_a, it_a = a[:5]
    err_b, ok_b, conv_b, norm_b, it_b = b[:5]
    return (err_a == err_b) & (ok_a == ok_b) & (conv_a == conv_b) \
        & (norm_a == norm_b) & (it_a == it_b)


def int_max_abs(a, b) -> float:
    """The largest gap of err / ok / conv / norm / iters over all frames."""
    import torch

    return float(max((x.to(torch.float64) - y.to(torch.float64)).abs().max().item()
                     for x, y in zip(a[:5], b[:5])))


def compare(name: str, variant: str, kern, plain, bar_note: str) -> float:
    """Kernel outputs against the plain version's: exact for the min-sum
    family, >= 99% of frames for SPA. Returns the largest gap of err / ok /
    conv / norm / iters over all frames."""
    same = frames_equal(kern, plain)
    frac = float(same.float().mean())
    gap = int_max_abs(kern, plain)
    log(f"  {name}: frames equal {frac:.6f} ({bar_note}), max |diff| "
        f"{gap:g}, kernel's frames converged {float(kern[1].float().mean()):.4f}")
    if variant == "spa":
        if frac < 0.99:
            fail(f"{name} spa agrees on {frac:.4f} of frames (< 0.99)")
    elif not bool(same.all()):
        bad = (~same).nonzero().flatten()[:10].tolist()
        fail(f"{name} {variant} differs from its plain version at frames {bad}")
    return gap


def hold_mc(tag: str, mc, dec, wT, consts, **noise):
    """K1 against its plain version on the same inputs (``raw`` words or
    Philox ``seeds``). The emitted LLRs to the channel bar; the counters
    exact for the min-sum family (against the plain decode ``dec`` of the
    kernel's own LLRs when they are emitted, since the two may differ by an
    ulp of the channel math), on >= 99% of frames for SPA. Returns the
    kernel's outputs and the largest error."""
    import torch

    kern = mc(wT, consts, **noise)
    sync()
    plain = mc.plain(wT, consts, **noise)
    err = 0.0
    if mc.emit_llr:
        llr_k, llr_p = kern[5], plain[5]
        if not torch.isfinite(llr_k).all():
            fail(f"{tag} emitted non-finite LLRs")
        err = float((llr_k - llr_p).abs().max())
        log(f"  {tag}: LLR max |err| {err:.3g}, bit-equal share "
            f"{float((llr_k == llr_p).float().mean()):.6f}")
        if not torch.allclose(llr_k, llr_p, rtol=1e-5, atol=1e-4):
            fail(f"{tag} LLRs outside rtol 1e-5 / atol 1e-4")
        if mc.variant != "spa":
            B = wT.shape[1]
            plain = dec.plain(llr_k.clone(), wT,
                              torch.zeros(B, device=wT.device))
    return kern, max(err, compare(tag, mc.variant, kern, plain, "counters"))


def hold_pair(tag: str, code, groups, variant: str, wT, consts, done0, *,
              iters: int, phase1: int, check_every: int, mode: int = 1,
              modulation: int = 1, raw=None, **options):
    """K1 (``phase1`` iterations, LLRs emitted) with injected words, when
    given, and with Philox noise; then K2 (``iters``) from K1's LLRs with
    the pre-done mask ``done0``. ``options``: the decoders' schedule,
    track_norm, msg_store and alpha. Returns the largest error of
    each."""
    from ldpc_tpu_torch.ops.mc_kernels import LLRDecoder, MCDecoder

    info_pos = code.standard_encode_spec.info_pos("orig")
    kw = dict(layer_groups=groups, check_every=check_every, **options)
    mc = MCDecoder(code.qc, info_pos, phase1, variant, mode=mode,
                   modulation=modulation, emit_llr=True, **kw)
    tag = f"{tag} ({plan_tag(mc.plan)})"
    dec1 = LLRDecoder(code.qc, info_pos, phase1, variant, **kw)
    llr2 = LLRDecoder(code.qc, info_pos, iters, variant, **kw)
    out = {"mc_decoder": 0.0, "llr_decoder": 0.0}
    sources = ([("raw", dict(raw=raw))] if raw is not None else []) + [
        ("philox", dict(seeds=(0x9E3779B9, 0x7F4A7C15)))]
    for src, noise in sources:
        kern, e = hold_mc(f"{tag} mc_decoder {src}", mc, dec1, wT, consts,
                          **noise)
        out["mc_decoder"] = max(out["mc_decoder"], e)
    # K2 from the last K1 run's LLRs, as phase 2 sees them
    k2 = llr2(kern[5], wT, done0)
    sync()
    p2 = llr2.plain(kern[5], wT, done0)
    out["llr_decoder"] = compare(f"{tag} llr_decoder", variant, k2, p2,
                                 "random pre-done mask")
    return out


# alpha schedules: [T, D] for codes of two row degrees (WiMAX rate 1/2: 6
# and 7) and [T], each shorter than the budget, so that its last value
# repeats (alpha[min(it, T-1)])
ALPHA_TD = ((0.65, 0.62), (0.75, 0.70), (0.79, 0.71), (0.80, 0.77),
            (0.83, 0.78), (0.81, 0.80))
ALPHA_T = (0.64, 0.73, 0.77, 0.78, 0.80, 0.80, 0.81, 0.81, 0.82)
CCSDS32 = "builtin:CCSDS_ldpc_n32_k16.alist.txt"
N4608 = "examples/big_code/wimax_like_n4608_z192.alist.txt"
N9216 = "examples/big_code/wimax_like_n9216_z384.alist.txt"

# configurations the main path does not run, held at a small batch so that
# every code path of the kernels meets its plain version on the card:
# (code, layer order or "flooding", variant, channel mode, modulation,
# iterations, check every, Eb/N0 dB chosen so that some frames converge in
# phase 1 and some do not, the decoders' other options)
COVERAGE = [
    # multi-diagonal layers (the additive update), kernel row degree 8; Z=4:
    # 8 codewords share one warp
    ("builtin:CCSDS_ldpc_n32_k16.alist.txt", "serial", "normalized_minsum",
     1, 1, 12, 2, 2.0, {}),
    ("builtin:CCSDS_ldpc_n32_k16.alist.txt", "serial", "spa", 3, 2, 10, 1,
     5.0, {}),
    ("builtin:CCSDS_ldpc_n256_k128.alist.txt", "serial", "offset_minsum", 2,
     1, 12, 2, 2.5, {}),
    # Z = 16: 2 codewords share a warp
    ("builtin:CCSDS_ldpc_n128_k64.alist.txt", "serial", "normalized_minsum",
     1, 1, 12, 2, 2.5, {}),
    # row degree 15 (the 16 instantiation), partial-band, QPSK proxy; 48
    # threads per codeword padded to 64
    ("builtin:wimax_1152_0.75A.alist.txt", "serial", "offset_minsum", 2, 2,
     12, 2, 7.0, {}),
    # row degree 20 (48 threads padded to 64) and 22 (the 32 instantiation;
    # 27 threads padded to 32)
    ("builtin:wimax_1152_0.83.alist.txt", "serial", "minsum", 3, 1, 12, 3,
     3.5, {}),
    ("builtin:wifi_648_r083.alist.txt", "serial", "spa", 2, 2, 12, 2, 8.5, {}),
    # one codeword of 192, 384 and 768 threads (Z = 96, 192, 384, paired)
    ("builtin:wimax_2304_0.66B.alist.txt", "paired", "normalized_minsum", 3,
     2, 12, 2, 5.5, {}),
    ("examples/big_code/wimax_like_n4608_z192.alist.txt", "paired", "minsum",
     1, 1, 12, 2, 2.0, {}),
    ("examples/big_code/wimax_like_n9216_z384.alist.txt", "paired", "spa", 3,
     2, 12, 2, 5.5, {}),
    # flooding (K1, K2): with and without the flip metric, 4 codewords
    # sharing a warp (CCSDS n32), one codeword of 384 and 768 threads
    # (n=4608, n=9216)
    (W1152, "flooding", "spa", 1, 1, 16, 1, 2.0, dict(track_norm=True)),
    (W1152, "flooding", "spa", 1, 2, 16, 2, 2.0, {}),
    (W1152, "flooding", "normalized_minsum", 2, 1, 16, 1, 2.5,
     dict(track_norm=True)),
    (W1152, "flooding", "offset_minsum", 3, 1, 16, 2, 2.5, {}),
    (CCSDS32, "flooding", "minsum", 1, 1, 12, 1, 3.0, dict(track_norm=True)),
    (N4608, "flooding", "normalized_minsum", 1, 1, 16, 1, 2.0,
     dict(track_norm=True)),
    (N9216, "flooding", "spa", 1, 1, 16, 2, 1.5, {}),
    # int8 E on the min-sum family: multi-diagonal layers, paired layers,
    # flooding with the flip metric
    (CCSDS32, "serial", "normalized_minsum", 1, 1, 12, 2, 2.0,
     dict(msg_store="int8")),
    (W1152, "paired", "minsum", 1, 1, 12, 2, 2.5, dict(msg_store="int8")),
    (W1152, "flooding", "normalized_minsum", 1, 1, 20, 1, 2.0,
     dict(msg_store="int8", track_norm=True)),
    # alpha schedules: [T, D] layered, [T] flooding with int8 E
    (W1152, "paired", "normalized_minsum", 1, 1, 12, 2, 2.0,
     dict(alpha=ALPHA_TD)),
    (W1152, "flooding", "normalized_minsum", 1, 1, 12, 1, 2.0,
     dict(alpha=ALPHA_T, msg_store="int8")),
]
COVER_BATCH = 512


def phase_coverage(dev) -> float:
    """Every COVERAGE case through :func:`hold_pair` with injected words;
    returns the largest error over all of them."""
    import numpy as np
    import torch

    from ldpc_tpu_torch.models.qc import paired_layer_groups
    from ldpc_tpu_torch.ops.channel import ChannelParams
    from ldpc_tpu_torch.ops.encode import make_encoder_T
    from ldpc_tpu_torch.ops.mc_kernels import DRAWS_PER_BIT
    from ldpc_tpu_torch.sim.runner import load_code

    worst = 0.0
    gen = np.random.default_rng(2)
    for (name, order, variant, mode, modulation, iters, ce, snr,
         options) in COVERAGE:
        code = load_code(name if name.startswith("builtin:")
                         else str(ROOT / name))
        groups = paired_layer_groups(code.qc) if order == "paired" else None
        schedule = "flooding" if order == "flooding" else "layered"
        u = torch.from_numpy(gen.integers(0, 2, (COVER_BATCH, code.k),
                                          dtype=np.uint8)).to(dev)
        wT = make_encoder_T(code.standard_encode_spec, "orig", dev)(u)
        raw = torch.from_numpy(gen.integers(
            0, 2**32, (DRAWS_PER_BIT[mode], code.n, COVER_BATCH),
            dtype=np.uint32).view(np.int32)).to(dev)
        consts = ChannelParams(mode=mode, modulation=modulation,
                               speed=code.rate, snr_db=snr,
                               noise_model="exact").consts(dev)
        done0 = torch.from_numpy(
            (gen.random(COVER_BATCH) < 0.5).astype(np.float32)).to(dev)
        out = hold_pair(f"{code.name} {order} {variant} mode {mode} mod "
                        f"{modulation} ce{ce} {options or ''}", code, groups,
                        variant, wT, consts, done0, iters=iters,
                        phase1=iters // 2, check_every=ce, mode=mode,
                        modulation=modulation, raw=raw, schedule=schedule,
                        **options)
        worst = max(worst, *out.values())
    return worst


# K1's refill (codewords sharing a warp, one pass of the layered schedule):
# the codes (2 and 8 codewords a warp), variants and Eb/N0 points held, and
# the batches it is timed at: within one wave of blocks at both codes but
# n=128 at 8192, and the cell's
REFILL_CODES = ("builtin:CCSDS_ldpc_n128_k64.alist.txt", CCSDS32)
REFILL_VARIANTS = ("spa", "normalized_minsum")
REFILL_SNRS = (1.5, 3.0)
REFILL_TIME_BATCHES = (4096, 8192, 131072)


def hold_refill(tag: str, mc, block, wT, consts, **noise) -> dict:
    """K1's call of ``mc`` against ``block``, the same decoder launched
    block per group, and against its plain version (the bars of
    :func:`compare`), on the same inputs. Within one wave of blocks the
    call does not refill: all five outputs equal the block launch's, the
    idle word left at 0. Over it, ``iters`` are each codeword's own trips
    against the plain version, and against the block launch: err / ok / conv / norm equal bit for bit; ``iters``
    equal to the own trips that ok and conv give (so their sums are equal),
    and the block launch's ``iters`` their largest over each block; the
    idle word at most the grid's lane groups x the budget. Returns the
    launch's grid, refills, idle word and lane trips."""
    import torch

    from ldpc_tpu_torch.ops.decode_loop import block_max_trips

    B, dev = wT.shape[1], wT.device
    idle = torch.zeros(1, dtype=torch.float64, device=dev)
    kern = mc(wT, consts, idle=idle, **noise)
    blk = block(wT, consts, **noise)
    sync()
    refills = mc.refills(B, dev)
    names = ("err", "ok", "conv", "norm", "iters")[:5 if refills == 0 else 4]
    for name, a, b in zip(names, kern, blk):
        if not torch.equal(a, b):
            bad = (a != b).nonzero().flatten()[:10].tolist()
            fail(f"{tag}: {name} of the refill differs from the block "
                 f"launch's at frames {bad}")
    compare(f"{tag} against plain", mc.variant, kern,
            mc.plain(wT, consts, **noise),
            "own trips" if refills else "block trips")
    if refills == 0:
        if float(idle.item()) != 0:
            fail(f"{tag}: a call within one wave added {idle.item()} idle")
        log(f"  {tag}: within one wave, block per group")
        return {"grid": 0, "refills": 0, "idle": 0.0,
                "lane_trips": int(blk[4].sum())}
    own = torch.where(kern[1], kern[2] + 1, mc.max_iterations)
    if not torch.equal(kern[4].to(own.dtype), own):
        fail(f"{tag}: iters are not each codeword's own trips")
    want = block_max_trips(kern[1], kern[2], mc.lanes, mc.max_iterations)
    if not torch.equal(blk[4].to(want.dtype), want):
        fail(f"{tag}: the block launch's iters are not its codewords' largest")
    grid, w = mc.grid(B, dev), float(idle.item())
    lanes_trips = int(own.sum()) + w
    if not (0 <= w <= grid * mc.lanes * mc.max_iterations and w == int(w)):
        fail(f"{tag}: idle word {w} outside [0, {grid} x {mc.lanes} x "
             f"{mc.max_iterations}]")
    log(f"  {tag}: grid {grid} x {mc.lanes} lane groups, refills "
        f"{refills}, own trips {int(own.sum())}, idle {w:g}, block "
        f"launch's lane trips {int(blk[4].sum())}")
    return {"grid": grid, "refills": refills, "idle": w,
            "lane_trips": lanes_trips}


def phase_refill(dev, smi: str, peak: float) -> dict:
    """K1's refill held (:func:`hold_refill`) for each of ``REFILL_CODES`` x
    ``REFILL_VARIANTS`` x ``REFILL_SNRS``, with injected words and with
    Philox, at a batch within one wave (1001 frames: an odd batch, so one
    lane group never holds a codeword) and at a batch over the card's grid
    that is no multiple of its lane groups (2 grids' lane groups + 7).
    Then K1 (SPA-12, a check every 2 sweeps, Philox, 3.0 dB) timed as the
    call chooses and block per group, in turns, at both codes and
    ``REFILL_TIME_BATCHES`` (the cell's: CCSDS (128, 64) at 131,072
    frames), each with its bound. Returns the timings by code and batch."""
    import numpy as np
    import torch

    from ldpc_tpu_torch.analysis.roofline import (
        channel_census,
        decode_work,
        lane_sweeps,
    )
    from ldpc_tpu_torch.ops.channel import ChannelParams
    from ldpc_tpu_torch.ops.encode import make_encoder_T
    from ldpc_tpu_torch.ops.mc_kernels import DRAWS_PER_BIT, MCDecoder
    from ldpc_tpu_torch.sim.runner import load_code

    gen = np.random.default_rng(3)
    seeds = (0x6A09E667, 0xBB67AE85)
    for name in REFILL_CODES:
        code = load_code(name)
        info = code.standard_encode_spec.info_pos("orig")
        enc = make_encoder_T(code.standard_encode_spec, "orig", dev)
        for variant in REFILL_VARIANTS:
            mc = MCDecoder(code.qc, info, 12, variant, check_every=2)
            block = MCDecoder(code.qc, info, 12, variant, check_every=2)
            block.refill = False
            if not mc.refill:
                fail(f"{code.name} {variant}: the one-pass K1 does not refill")
            full = mc.grid(1 << 30, dev)
            for snr in REFILL_SNRS:
                consts = ChannelParams(mode=1, modulation=1, speed=code.rate,
                                       snr_db=snr,
                                       noise_model="exact").consts(dev)
                for B in (1001, 2 * full * mc.lanes + 7):
                    u = torch.from_numpy(gen.integers(
                        0, 2, (B, code.k), dtype=np.uint8)).to(dev)
                    wT = enc(u)
                    raw = torch.from_numpy(gen.integers(
                        0, 2**32, (DRAWS_PER_BIT[1], code.n, B),
                        dtype=np.uint32).view(np.int32)).to(dev)
                    for src, noise in (("raw", dict(raw=raw)),
                                       ("philox", dict(seeds=seeds))):
                        hold_refill(f"{code.name} {variant} {snr} dB B={B} "
                                    f"{src}", mc, block, wT, consts, **noise)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timed = {}
    for name in REFILL_CODES:
        code = load_code(name)
        info = code.standard_encode_spec.info_pos("orig")
        mc = MCDecoder(code.qc, info, 12, "spa", check_every=2)
        block = MCDecoder(code.qc, info, 12, "spa", check_every=2)
        block.refill = False
        for B in REFILL_TIME_BATCHES:
            u = torch.from_numpy(gen.integers(0, 2, (B, code.k),
                                              dtype=np.uint8)).to(dev)
            wT = make_encoder_T(code.standard_encode_spec, "orig", dev)(u)
            consts = ChannelParams(mode=1, modulation=1, speed=code.rate,
                                   snr_db=3.0,
                                   noise_model="exact").consts(dev)
            held = hold_refill(f"{code.name} spa 3.0 dB B={B} philox", mc,
                               block, wT, consts, seeds=seeds)
            t = {"call": [], "block": []}
            for turn in ("call", "block", "block", "call"):
                dec = mc if turn == "call" else block
                t[turn].append(time_ms(lambda: dec(wT, consts, seeds=seeds),
                                       reps=max(20, 2_000_000 // B)))
            res = {k: float(np.mean(v)) for k, v in t.items()}
            out = mc(wT, consts, seeds=seeds)
            sw = lane_sweeps(out[1].cpu().numpy(), out[2].cpu().numpy(), 12)
            ops = decode_work(code.qc, "spa", "layered", sweeps=sw,
                              check_every=2) \
                + B * channel_census(code.qc).total()
            bound, by = bound_ms(ops, 4 * code.n * B + 32 + 17 * B, peak)
            log(f"K1 timing ({code.name}, spa-12 ce2, 3.0 dB, B={B}, "
                f"Philox; {smi}): as the call chooses ("
                f"{'refill' if held['refills'] else 'block per group'}) "
                f"{t['call']} ms, block per group {t['block']} ms (means "
                f"{res['call']:.5f} / {res['block']:.5f}, "
                f"{100 * (res['call'] / res['block'] - 1):+.2f}%); bound "
                f"{bound:.5f} ms by {by} ({ops:.6g} census ops, "
                f"{int(sw.sum())} own sweeps); grid {held['grid']} blocks "
                f"({mc.blocks_per_sm(dev)} blocks/SM block per group, "
                f"{held['grid'] // sms} refill), refills {held['refills']}, "
                f"idle {held['idle']:g} of {held['lane_trips']:g} lane trips")
            timed[code.name, B] = dict(res, bound=bound, by=by, ops=ops)
    return timed


def phase_fer(batches: int) -> None:
    """FER at the headline point from two independent noise sources, for
    the paired and the serial layer order, single pass: ``philox`` is the
    main path (``run_point``, the kernel's in-kernel Philox4x32-10);
    ``torch`` feeds the same kernel words drawn by ``torch.randint`` on the
    card (the injected-noise layout) through ``PointExecutor.step``. Each
    line gives frames, frame errors, FER and its standard error."""
    import torch

    from ldpc_tpu_torch.ops.encode import random_info_bits
    from ldpc_tpu_torch.ops.mc_kernels import DRAWS_PER_BIT
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code

    code = load_code("builtin:wimax_1152_0.5.alist.txt")
    for order in ("paired", "serial"):
        opts = SimOptions(
            matrix=code.name, iterations=ITERS, fidelity="exact", batch=BATCH,
            seed=5, speed=0.5, schedule="layered", layer_order=order,
            check_every=CHECK_EVERY, two_phase="off",
        )
        ex = PointExecutor(code, opts)
        consts = ex.consts(SNR_DB)
        st = ex.run_point(SNR_DB, batches * BATCH)
        counts = {"philox": (st.blocks, st.fer_frames)}
        gen = torch.Generator(device=ex.device).manual_seed(12345)
        fails = torch.zeros((), dtype=torch.int64, device=ex.device)
        for i in range(batches):
            u = random_info_bits(gen, BATCH, code.k)
            raw = torch.randint(-2**31, 2**31, (DRAWS_PER_BIT[1], code.n, BATCH),
                                generator=gen, device=ex.device,
                                dtype=torch.int32)
            stats, _ = ex.step(i, consts, 0, u=u, raw=raw)
            fails += (~stats.ok).sum()
        counts["torch"] = (batches * BATCH, int(fails))
        for source, (frames, errors) in counts.items():
            fer = errors / frames
            se = math.sqrt(fer * (1 - fer) / frames)
            log(f"fer order={order} source={source} frames={frames} "
                f"frame_errors={errors} FER={fer:.6f} se={se:.6f}")


DECODE_LIBRARIES = ("mc_decoder", "llr_decoder", "qc_decoder")


def phase_ptxas() -> dict:
    """Registers, barriers and spill bytes of every decode-kernel
    instantiation (K1, K2, K3: <DMAX, flooding, flip metric, int8 E>; K1
    also <DMAX, 0, 0, int8 E, refill>), from
    the builds' ``ptxas -v``; fails if a DMAX=8 one spills or takes more
    than 80 registers."""
    from ldpc_tpu_torch.ops import build

    rep = {}
    for lib in DECODE_LIBRARIES:
        rep.update(build.ptxas_report(build.ptxas_log(lib)))
    decode = sorted(k for k in rep if k.startswith((
        "mc_decoder_kernel<", "llr_decoder_kernel<", "qc_decoder_kernel<")))
    log("ptxas K1/K2/K3: " + "; ".join(
        f"{k} {rep[k].get('registers')} registers, {rep[k].get('barriers')} "
        f"barriers, spill stores {rep[k].get('spill_stores')} B, loads "
        f"{rep[k].get('spill_loads')} B, stack {rep[k].get('stack')} B"
        for k in decode))
    # K1, K2, K3 x DMAX 8 / 16 / 32 x flooding x flip metric x int8 E, and
    # K1's refill x DMAX x int8 E
    if len(decode) != 78:
        fail(f"expected 78 decode-kernel instantiations in the ptxas output, "
             f"found {len(decode)}: {decode}")
    for k in decode:
        if k.split("<")[1].startswith("8,") and (
                rep[k].get("spill_stores") or rep[k].get("spill_loads")
                or rep[k].get("registers", 0) > 80):
            fail(f"{k} spills or exceeds 80 registers: {rep[k]}")
    return {k: rep[k] for k in decode}


def plan_tag(p) -> str:
    """A block plan in a log line."""
    return (f"{p.lanes} codeword(s) per block, {p.rows} row(s) per step, "
            f"{p.threads} threads, {p.padding_threads} padding, {p.smem} B"
            + (", int8 E" if p.int8 else ""))


# ------------------------------------------------------------------- K3 ----

def channel_llrs(code, B: int, snr_db: float, seed: int, dev, **channel):
    """Channel LLRs (LLR > 0 <=> bit 1) of ``B`` random codewords of
    ``code`` through the port's channel on the card, f32 [B, n]; BPSK and
    mode 1 unless ``channel`` says otherwise (``mode``, ``modulation``, and
    the partial-band ``p`` / ``interference_snr_db``)."""
    import torch

    from ldpc_tpu_torch.ops.channel import ChannelParams, make_channel
    from ldpc_tpu_torch.ops.encode import make_encoder, random_info_bits

    gen = torch.Generator(device=dev).manual_seed(seed)
    u = random_info_bits(gen, B, code.k)
    w = make_encoder(code.standard_encode_spec, "orig", dev)(u)
    params = ChannelParams(speed=code.rate, snr_db=snr_db, noise_model="exact",
                           **channel)
    return make_channel(params, n=code.n, device=dev)(gen, w).contiguous()


def hold_qc(tag: str, dec, llr, skip: int = 0):
    """K3 against its plain version on the same LLRs: decisions, ok, conv,
    norm and the per-codeword block trip counts equal bit for bit (every
    variant). Returns the kernel's outputs and the largest error."""
    import torch

    kern = dec.outputs(llr, skip)
    sync()
    plain = dec.plain_outputs(llr, skip)
    names = ("est", "ok", "conv", "norm", "iters")
    gaps = {}
    for name, a, b in zip(names, kern, plain):
        gaps[name] = float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) \
            if a.numel() else 0.0
    same = (kern[0] == plain[0]).all(dim=1) & (kern[1] == plain[1]) \
        & (kern[2] == plain[2]) & (kern[3] == plain[3]) & (kern[4] == plain[4])
    frac = float(same.float().mean())
    log(f"  {tag}: frames equal {frac:.6f}, max |diff| "
        + " ".join(f"{k} {v:g}" for k, v in gaps.items())
        + f", converged {float(kern[1].float().mean()):.4f}, "
          f"trips max {int(kern[4].max())}")
    if frac != 1.0:
        bad = (~same).nonzero().flatten()[:10].tolist()
        fail(f"{tag} differs from its plain version at frames {bad}")
    return kern, max(gaps.values())


# K3 configurations beyond the main cases, at 512 frames: (code, schedule,
# layer order, variant, iterations, check every, track_norm, Eb/N0 dB,
# channel, skip, the decoder's alpha / msg_store)
QC_COVERAGE = [
    # multi-diagonal (two circulants in one base column): both schedules
    ("builtin:CCSDS_ldpc_n32_k16.alist.txt", "flooding", "serial",
     "normalized_minsum", 12, 1, True, 3.0, {}, 0, {}),
    ("builtin:CCSDS_ldpc_n32_k16.alist.txt", "layered", "serial", "spa", 10,
     1, True, 3.0, {}, 0, {}),
    # row degree 15 (the 16 instantiation), 20 and 22 (the 32 one)
    ("builtin:wimax_1152_0.75A.alist.txt", "flooding", "serial",
     "offset_minsum", 16, 1, True, 3.0, {}, 0, {}),
    ("builtin:wimax_1152_0.83.alist.txt", "layered", "serial", "minsum", 12,
     3, False, 3.5, {}, 0, {}),
    ("builtin:wifi_648_r083.alist.txt", "flooding", "serial", "spa", 16, 2,
     False, 4.0, {}, 0, {}),
    # every lane pre-marked done
    (W1152, "flooding", "serial", "spa", 16, 1, True, 2.0, {}, 1, {}),
    # flooding at Z = 192 and 384 (one codeword of 384 and 768 threads;
    # n=9216: 208.4 KB of shared memory per block)
    ("examples/big_code/wimax_like_n4608_z192.alist.txt", "flooding",
     "serial", "minsum", 16, 1, True, 2.0, {}, 0, {}),
    ("examples/big_code/wimax_like_n9216_z384.alist.txt", "flooding",
     "serial", "spa", 16, 2, False, 1.5, {}, 0, {}),
    # n=9216 layered paired SPA-12 with a check every two sweeps
    ("examples/big_code/wimax_like_n9216_z384.alist.txt", "layered",
     "paired", "spa", 12, 2, False, 2.0, {}, 0, {}),
    # 16-QAM mode-2 LLRs as input
    (W1152, "layered", "paired", "spa", 12, 2, False, 5.5,
     dict(modulation=16, mode=2, p=0.15, interference_snr_db=-3.0), 0, {}),
    # int8 E at n=9216, layered paired normalized min-sum
    (N9216, "layered", "paired", "normalized_minsum", 12, 2, False, 2.0, {}, 0,
     dict(msg_store="int8")),
    # a [T] schedule under flooding with the flip metric; a [T, D] one with
    # int8 E, layered serial
    (W1152, "flooding", "serial", "normalized_minsum", 16, 1, True, 2.0, {}, 0,
     dict(alpha=ALPHA_T)),
    (W1152, "layered", "serial", "normalized_minsum", 12, 1, True, 2.0, {}, 0,
     dict(alpha=ALPHA_TD, msg_store="int8")),
]


def qc_decoder_for(code, schedule, order, variant, iters, ce, norm, **options):
    from ldpc_tpu_torch.models.qc import paired_layer_groups
    from ldpc_tpu_torch.ops.qc_kernels import QCDecoder

    groups = paired_layer_groups(code.qc) if order == "paired" else None
    return QCDecoder(code.qc, code.standard_encode_spec.info_pos("orig"),
                     iters, variant, schedule=schedule, track_norm=norm,
                     layer_groups=groups, check_every=ce, **options)


def phase_qc_compare(dev):
    """Phase 6: K3 against its plain version, main cases then QC_COVERAGE.
    Returns (largest error, {case: (decoder, llr, kernel outputs)}) for the
    timing phase."""
    from ldpc_tpu_torch.sim.runner import load_code

    code = load_code(W1152)
    bpsk = channel_llrs(code, BATCH, SNR_DB, 11, dev)
    qam = channel_llrs(code, BATCH, 5.5, 12, dev, **{
        k: BURST[k] for k in ("modulation", "mode", "p")},
        interference_snr_db=BURST["interference_snr"])
    worst, kept = 0.0, {}
    log(f"compare qc_decoder (wimax 1152, B={BATCH}):")
    for tag, sched, order, variant, iters, ce, norm, llr in (
        ("flooding spa-16 norm", "flooding", "serial", "spa", 16, 1, True, bpsk),
        ("flooding spa-16", "flooding", "serial", "spa", 16, 1, False, bpsk),
        ("layered spa-12 serial (16-QAM)", "layered", "serial", "spa", 12, 1,
         False, qam),
        ("layered spa-12 paired ce2", "layered", "paired", "spa", 12, 2, False,
         bpsk),
        ("flooding nms-16 norm", "flooding", "serial", "normalized_minsum", 16,
         1, True, bpsk),
    ):
        dec = qc_decoder_for(code, sched, order, variant, iters, ce, norm)
        out, e = hold_qc(f"{tag} ({plan_tag(dec.plan)}, "
                         f"{dec.blocks_per_sm(dev)} blocks/SM)", dec, llr)
        worst = max(worst, e)
        kept[tag] = (dec, llr, out)
    log(f"compare qc_decoder (other configurations, B={COVER_BATCH}):")
    for (name, sched, order, variant, iters, ce, norm, snr, ch,
         skip, options) in QC_COVERAGE:
        c = load_code(name if name.startswith("builtin:") else str(ROOT / name))
        dec = qc_decoder_for(c, sched, order, variant, iters, ce, norm,
                             **options)
        llr = channel_llrs(c, COVER_BATCH, snr, 13, dev, **ch)
        tag = (f"{c.name} {sched} {order} {variant}-{iters} ce{ce} norm {norm} "
               f"{snr} dB {ch or 'bpsk'} skip {skip} {options or ''} "
               f"({plan_tag(dec.plan)})")
        worst = max(worst, hold_qc(tag, dec, llr, skip)[1])
    return worst, kept


QAM_CODES = (W1152, "builtin:wimax_576_0.5.alist.txt")


def phase_qam_channel(dev, smi: str) -> dict:
    """Phase 6b: K6 ``qam_channel`` against its plain version (the
    interleave -> channel -> deinterleave chain) at B=4096 on WiMAX
    codewords of n=1152 and n=576, for every channel mode x QAM order 4 /
    16 / 64 x interleaver none / regular / random, each side from
    generators of the same seeds: the LLRs equal bit for bit (max |diff|
    0), one launch a call. Then K6 timed with CUDA events at the 16-QAM
    jamming configuration (mode 2, random interleaver, n=1152) beside its
    bound by bytes, the wrapper's whole call (the draws and the argsort
    with it) and the plain chain. Returns the ``kernels`` entry less its
    ``launches``, which come from the main path's headline run (phase 7)."""
    import torch

    from ldpc_tpu_torch.ops import build
    from ldpc_tpu_torch.ops.channel import ChannelParams
    from ldpc_tpu_torch.ops.encode import make_encoder, random_info_bits
    from ldpc_tpu_torch.ops.qam_channel import QAM_CHANNEL, QAMChannel
    from ldpc_tpu_torch.sim.runner import load_code

    def gens(seed):
        return (torch.Generator(device=dev).manual_seed(seed),
                torch.Generator(device=dev).manual_seed(seed + 1))

    def consts_of(mode, order):
        return ChannelParams(mode=mode, modulation=order, speed=0.5,
                             snr_db=5.5, interference_snr_db=-3.0, p=0.15,
                             noise_model="exact").consts(dev)

    log(f"compare qam_channel (B={BATCH}, max |diff| against the plain "
        "chain, bar 0):")
    worst, cases, launches0 = 0.0, 0, QAM_CHANNEL.launches
    for name in QAM_CODES:
        code = load_code(name)
        w = make_encoder(code.standard_encode_spec, "orig", dev)(
            random_info_bits(gens(3)[0], BATCH, code.k))
        row = []
        for mode in (1, 2, 3):
            for order in (4, 16, 64):
                consts = consts_of(mode, order)
                for kind in ("none", "regular", "random"):
                    ch = QAMChannel(mode, order, code.n, kind, device=dev)
                    got = ch(*gens(17), w, consts)
                    want = ch.plain(*gens(17), w, consts)
                    sync()
                    gap = float((got - want).abs().max())
                    row.append(f"m{mode} q{order} {kind} {gap:g}")
                    if not torch.equal(got, want):
                        fail(f"qam_channel n={code.n} mode {mode} order "
                             f"{order} {kind}: {int((got != want).sum())} of "
                             f"{got.numel()} LLRs differ, max |diff| {gap:g}")
                    worst, cases = max(worst, gap), cases + 1
        log(f"  n={code.n} ({ch.frames} frame(s), {ch.threads} threads a "
            f"block at 64-QAM): " + ", ".join(row))
    launches = QAM_CHANNEL.launches - launches0
    log(f"qam_channel launches in phase 6b: {launches} for {cases} calls")
    if launches != cases:
        fail(f"qam_channel launched {launches} times for {cases} calls")
    log("ptxas qam_channel: " + ", ".join(
        f"{k} {v}" for k, v in build.ptxas_report(
            build.ptxas_log("qam_channel")).items()))

    code = load_code(W1152)
    n, mode, order = code.n, 2, 16
    w = make_encoder(code.standard_encode_spec, "orig", dev)(
        random_info_bits(gens(5)[0], BATCH, code.k))
    consts = consts_of(mode, order)
    ch = QAMChannel(mode, order, n, "random", device=dev)
    g_draw, g_call, g_plain = gens(31), gens(41), gens(51)
    drawn = ch.draws(*g_draw, BATCH)
    t_k6 = time_ms(lambda: ch.launch(w, *drawn, consts), reps=50)
    t_draws = time_ms(lambda: ch.draws(*g_draw, BATCH), reps=20)
    t_call = time_ms(lambda: ch(*g_call, w, consts), reps=20)
    t_plain = time_ms(lambda: ch.plain(*g_plain, w, consts), reps=20)
    # each byte once: codeword, permutation row, jam and two normals per
    # symbol, the LLRs out
    nbytes = BATCH * (4 * n + 8 * n + 3 * 4 * ch.n_sym + 4 * n)
    bound, by = bound_ms(0, nbytes, 1.0)
    log(f"timing qam_channel (16-QAM, mode 2, random, n={n}, B={BATCH}; "
        f"{smi}): {t_k6:.4f} ms (bound {bound:.5f} ms by {by}, {nbytes} "
        f"bytes: {100 * bound / t_k6:.1f}% of it); the draws and argsort "
        f"{t_draws:.4f} ms; the wrapper's call {t_call:.4f} ms; the plain "
        f"chain {t_plain:.4f} ms; {ch.frames} frame(s), {ch.threads} threads "
        f"a block")
    return {"name": "qam_channel", "route": "cuda",
            "source": CSRC + "qam_channel.cu", "replaces": None,
            "max_abs_err": worst, "ms": t_k6,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def phase_batch_counters(dev, smi: str) -> dict:
    """Phase 6c: K7 ``batch_counters`` against its plain version, its
    engagement in ``run_point`` and its time. Returns the ``kernels``
    entry."""
    import torch

    from ldpc_tpu_torch.ops import build
    from ldpc_tpu_torch.ops.metrics import (
        ADD_COUNTERS,
        BATCH_COUNTERS,
        BlockStats,
        launch_add_packed,
        launch_batch_counters,
        plain_add_packed,
        plain_batch_counters,
    )
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code
    from ldpc_tpu_torch.utils import timing

    gen = torch.Generator(device=dev).manual_seed(11)

    def stats_of(B, norm):
        ok = torch.rand(B, generator=gen, device=dev) < 0.6
        err = torch.randint(0, 60, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        conv = torch.randint(0, 12, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
        conv = torch.where(torch.rand(B, generator=gen, device=dev) < 0.7,
                           conv, -1)
        nl = (3 * torch.rand(B, generator=gen, device=dev) if norm
              else torch.zeros(B, device=dev))
        return BlockStats(torch.where(ok, 0, err), ok, conv, nl)

    log("compare batch_counters (integer slots equal, norm slot bit-equal "
        "over two launches and within 1e-6 of the plain f32 sum):")
    worst, calls = 0.0, 0
    n0, a0 = BATCH_COUNTERS.launches, ADD_COUNTERS.launches
    for B in (BATCH, 131072):
        for norm in (False, True):
            full = stats_of(B + 1, norm)
            its = torch.randint(1, 13, (B + 1,), generator=gen, device=dev,
                                dtype=torch.int32)
            # (lo, take, the arrays' offset in elements)
            cases = {"every row": (0, B, 0),
                     "part of a shard": (3 * B, 4 * B - 1000, 0),
                     "no row": (2 * B, 2 * B, 0),
                     "iters [1]": (B, 2 * B - 7, 0),
                     "misaligned": (0, B - 5, 1)}
            row = []
            for tag, (lo, take, skew) in cases.items():
                st = BlockStats(*(x[skew:skew + B] for x in full))
                it = its[skew:skew + B] if tag != "iters [1]" else its[:1]
                k1 = launch_batch_counters(st, it, lo, take)
                k2 = launch_batch_counters(st, it, lo, take)
                plain = plain_batch_counters(st, it, lo, take)
                calls += 2
                sync()
                f_k = float(k1[7:].view(torch.float32))
                f_p = float(plain[7:].view(torch.float32))
                valid = torch.arange(lo, lo + B, device=dev) < take
                f_64 = float(st.norm_llr.double()[valid].sum())
                rel = abs(f_k - f_p) / max(abs(f_p), 1e-30)
                row.append(f"{tag} {k1[:7].tolist()} norm {f_k:.9g} (plain "
                           f"{f_p:.9g}, float64 {f_64:.9g}, rel {rel:.3g})")
                if not torch.equal(k1, k2):
                    fail(f"batch_counters B={B} {tag}: two launches differ: "
                         f"{k1.tolist()} / {k2.tolist()}")
                if not torch.equal(k1[:7], plain[:7]):
                    fail(f"batch_counters B={B} {tag}: {k1.tolist()} against "
                         f"the plain {plain.tolist()}")
                if rel > 1e-6:
                    fail(f"batch_counters B={B} {tag}: norm sum {f_k!r} "
                         f"against the plain {f_p!r}")
                worst = max(worst, rel)
                for shape in ((9,), (3, 8)):
                    packed = k1.expand(*shape[:-1], 8).contiguous()
                    t_k = torch.arange(float(math.prod(shape)), device=dev,
                                       dtype=torch.float64).reshape(shape)
                    t_p = t_k.clone()
                    launch_add_packed(t_k, packed)
                    plain_add_packed(t_p, packed)
                    if not torch.equal(t_k, t_p):
                        fail(f"add_counters {shape}: {t_k.tolist()} against "
                             f"the plain {t_p.tolist()}")
            log(f"  B={B} norm {'values' if norm else 'zeros'}: "
                + "; ".join(row))
    launched = (BATCH_COUNTERS.launches - n0, ADD_COUNTERS.launches - a0)
    if launched != (calls, len(cases) * 4 * 2):
        fail(f"batch_counters / add_counters launched {launched} times for "
             f"{calls} / {len(cases) * 4 * 2} calls")
    log("ptxas batch_counters: " + ", ".join(
        f"{k} {v}" for k, v in build.ptxas_report(
            build.ptxas_log("batch_counters")).items()))

    # engagement: a launch of each a batch in run_point, the probe's too,
    # and the point's counters as the plain reduction gives them
    code = load_code(W1152)
    opts = SimOptions(matrix=code.name, blocks=BATCH, iterations=ITERS,
                      ber=True, fer=True, fidelity="exact", batch=BATCH,
                      seed=0, speed=0.5, schedule="layered",
                      layer_order="paired", check_every=CHECK_EVERY)
    frames = 5 * BATCH + 1000
    ex = PointExecutor(code, opts, device=dev)
    n0, a0 = BATCH_COUNTERS.launches, ADD_COUNTERS.launches
    st_k = ex.run_point(SNR_DB, frames, point_index=5)
    root = timing.units(timing.RECORDER.spans, "run_point")[-1][0]
    launched = (BATCH_COUNTERS.launches - n0, ADD_COUNTERS.launches - a0)
    ex_p = PointExecutor(code, opts, device=dev)
    ex_p.packed = lambda s, it, take: plain_batch_counters(
        s, it, ex_p._rows[0], take)
    st_p = ex_p.run_point(SNR_DB, frames, point_index=5)
    log(f"run_point through K7: {root.attrs['batches']} batches (probe "
        f"{root.attrs.get('probes', 0)}), launches batch_counters / "
        f"add_counters {launched}; counters {vars(st_k)}; through the plain "
        f"reduction {vars(st_p)}")
    if launched != (root.attrs["batches"],) * 2:
        fail(f"run_point ran {root.attrs['batches']} batches but K7 launched "
             f"{launched}")
    if vars(st_k) != vars(st_p):
        fail(f"run_point through K7 counted {vars(st_k)}, through the plain "
             f"reduction {vars(st_p)}")

    # time: K7 and the add by CUDA events; the host's enqueue of a batch's
    # counters, K7 against the plain operators
    times = {}
    for B in (BATCH, 131072):
        st = stats_of(B, False)
        it = torch.randint(1, 13, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
        acc = torch.zeros(9, dtype=torch.float64, device=dev)
        packed = launch_batch_counters(st, it, 0, B)
        t_k7 = time_queued_ms(lambda: launch_batch_counters(st, it, 0, B),
                              reps=200)
        t_add = time_queued_ms(lambda: launch_add_packed(acc, packed),
                               reps=200)
        t_plain = time_queued_ms(lambda: plain_add_packed(
            acc, plain_batch_counters(st, it, 0, B)), reps=20)

        def host_us(fn, reps=400):
            for _ in range(20):
                fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            t1 = time.perf_counter()
            sync()
            return 1e6 * (t1 - t0) / reps

        h_k7 = host_us(lambda: launch_add_packed(
            acc, launch_batch_counters(st, it, 0, B)))
        h_plain = host_us(lambda: plain_add_packed(
            acc, plain_batch_counters(st, it, 0, B)))
        nbytes = 17 * B + 32  # per frame 4 x 4 B and the verdict; int32[8]
        bound, by = bound_ms(0, nbytes, 1.0)
        times[B] = (t_k7, bound, by, t_plain)
        log(f"timing batch_counters (B={B}; {smi}): {t_k7:.5f} ms (bound "
            f"{bound:.4g} ms by {by}, {nbytes} bytes: "
            f"{100 * bound / t_k7:.2f}% of it), add_counters {t_add:.5f} ms; "
            f"the plain reduction and add {t_plain:.5f} ms; host enqueue a "
            f"batch {h_k7:.2f} us (plain {h_plain:.2f} us)")
    t_k7, bound, by, t_plain = times[BATCH]
    return {"name": "batch_counters", "route": "cuda",
            "source": CSRC + "batch_counters.cu", "replaces": None,
            "launches": launched[0], "max_abs_err": worst, "ms": t_k7,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


class RandomSpec:
    """A systematic code of random parity columns (P, a permuted domain):
    what ``GF2Encoder`` reads of an encode spec, at any k and n."""

    def __init__(self, k: int, n: int, seed: int):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.P = (rng.random((k, n - k)) < 0.5).astype(np.float32)
        self._map = rng.permutation(n)

    def domain_map(self, graph: str):
        return self._map


def phase_encode(dev, smi: str, peak: float) -> dict:
    """Phase 6d: K8 ``gf2_encode`` against its plain version, the f32
    product mod 2, bit for bit; its engagement in a fused and an unfused
    ``run_point``; its time. Returns the ``kernels`` entry."""
    import torch

    from ldpc_tpu_torch.ops import build
    from ldpc_tpu_torch.ops.encode import ENCODE, make_encoder, make_encoder_T
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code
    from ldpc_tpu_torch.utils import timing

    gen = torch.Generator(device=dev).manual_seed(21)
    ccsds = "builtin:CCSDS_ldpc_n128_k64.alist.txt"
    ghn = "builtin:LDPC_N336_K196_ITU_G.h.alist.txt"

    def bits(B, k, skew=0):
        """uint8 0/1 [B, k], starting ``skew`` bytes into its storage."""
        buf = torch.randint(0, 2, (B * k + skew,), generator=gen, device=dev,
                            dtype=torch.uint8)
        return buf[skew:].view(B, k)

    log("compare gf2_encode (equal bit for bit to its plain version, the f32 "
        "product mod 2):")
    wimax = load_code(W1152).standard_encode_spec
    ghn = load_code(ghn).standard_encode_spec  # k = 168 of the name's 196
    cases = []  # (tag, spec, graph, B, frames_minor, u)
    for graph in ("orig", "std"):
        for fm in (True, False):
            cases.append((f"wimax 1152 {graph}", wimax, graph, BATCH, fm,
                          bits(BATCH, 576)))
    for fm in (True, False):
        cases += [
            ("ccsds", load_code(ccsds).standard_encode_spec, "orig", 131072,
             fm, bits(131072, 64)),
            ("wimax 1152 shard rows", wimax, "orig", 1000, fm,
             bits(3000, 576)[1000:2000]),
            ("wimax 1152 misaligned", wimax, "orig", 777, fm,
             bits(777, 576, skew=3)),
            ("g.hn k=168", ghn, "orig", BATCH, fm, bits(BATCH, 168)),
            ("random k=1100 n=2000", RandomSpec(1100, 2000, 5), "orig", 300,
             fm, bits(300, 1100)),
        ]
    launches0 = ENCODE.launches
    for tag, spec, graph, B, fm, u in cases:
        make = make_encoder_T if fm else make_encoder
        enc = make(spec, graph, dev)
        got = enc(u)
        plain = enc.plain(u)
        sync()
        layout = "[n, B]" if fm else "[B, n]"
        same = torch.equal(got, plain)
        log(f"  {tag} B={B} {layout}: {tuple(got.shape)} equal {same}, ones "
            f"{float(got.mean()):.4f}")
        if not same:
            bad = (got != plain).nonzero()[:5].tolist()
            fail(f"gf2_encode {tag} {layout} differs at {bad}")
    if ENCODE.launches - launches0 != len(cases):
        fail(f"gf2_encode launched {ENCODE.launches - launches0} times for "
             f"{len(cases)} calls")
    log("ptxas gf2_encode: " + ", ".join(
        f"{k} {v}" for k, v in build.ptxas_report(
            build.ptxas_log("gf2_encode")).items()))

    # engagement: a launch a batch of a fused and of an unfused run_point
    code = load_code(W1152)
    launched = {}
    for fused in ("auto", "off"):
        opts = SimOptions(matrix=code.name, blocks=BATCH, iterations=ITERS,
                          ber=True, fer=True, fidelity="exact", batch=BATCH,
                          seed=0, speed=0.5, schedule="layered",
                          layer_order="paired", check_every=CHECK_EVERY,
                          fused=fused)
        ex = PointExecutor(code, opts, device=dev)
        n0 = ENCODE.launches
        ex.run_point(SNR_DB, 5 * BATCH + 1000, point_index=6)
        root = timing.units(timing.RECORDER.spans, "run_point")[-1][0]
        launched[fused] = (ENCODE.launches - n0, root.attrs["batches"])
        log(f"run_point fused={fused} ({ex.kernel_used}): gf2_encode "
            f"launched {launched[fused][0]} times over "
            f"{launched[fused][1]} batches (probe "
            f"{root.attrs.get('probes', 0)})")
        if launched[fused][0] != launched[fused][1]:
            fail(f"run_point fused={fused} ran {launched[fused][1]} batches "
                 f"but gf2_encode launched {launched[fused][0]} times")

    # time: K8 against its bounds and its plain version, the product
    times = {}
    for tag, spec, B, fm in (("wimax 1152", wimax, BATCH, True),
                             ("wimax 1152", wimax, BATCH, False),
                             ("ccsds", load_code(ccsds).standard_encode_spec,
                              131072, True)):
        enc = (make_encoder_T if fm else make_encoder)(spec, "orig", dev)
        u = bits(B, enc.k)
        words, cols = enc.table.shape
        t_k8 = time_queued_ms(lambda: enc(u), reps=20)
        t_plain = time_queued_ms(lambda: enc.plain(u), reps=20)
        nbytes = B * enc.k + 4 * enc.n * B + 4 * words * cols
        # what the function needs, priced at its pipes in issue-peak slots:
        # an AND-XOR (LOP3) a frame, column and word and the parity's AND at
        # 64 a clock an SM (2 slots), a popcount an output bit at 16 (8)
        ops = 2 * enc.n * B * (words + 1) + 8 * enc.n * B
        bound, by = bound_ms(ops, nbytes, peak)
        layout = "[n, B]" if fm else "[B, n]"
        times[(tag, layout)] = (t_k8, bound, by, t_plain)
        log(f"timing gf2_encode ({tag}, B={B}, {layout}; {smi}): "
            f"{t_k8:.5f} ms (bound {bound:.5f} ms by {by}: {nbytes} bytes, "
            f"{ops:.4g} issue slots; {100 * bound / t_k8:.1f}% of it); plain, "
            f"the f32 GEMM + cast + remainder, {t_plain:.5f} ms")
    t_k8, bound, by, t_plain = times[("wimax 1152", "[n, B]")]
    return {"name": "gf2_encode", "route": "cuda",
            "source": CSRC + "gf2_encode.cu", "replaces": None,
            "launches": launched["auto"][0], "max_abs_err": 0.0, "ms": t_k8,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": t_plain}


def five_se(errors: int, frames: int, ref: tuple[int, int]) -> tuple[float, float]:
    """|FER - reference FER| and 5 combined standard errors of the two: the
    studies' own comparison (``scripts.study.five_se``, from the pooled
    FER), so that every phase judges a FER by one statistic."""
    from ldpc_tpu_torch.scripts.study import five_se as held

    c = held(errors, frames, *ref)
    return c["gap"], c["five_se"]


def phase_unfused(dev):
    """Phases 7 and 8: the unfused path through ``run_simulation``, and the
    CLI's default flooding configuration both through K3 (``fused='off'``)
    and through the fused kernels. Returns K3's and K6's launches on the
    headline run, each counted from 0 just before it, and its batches; K7
    and its add must launch once a batch on each run."""
    import torch

    from ldpc_tpu_torch.ops.mc_kernels import LLR_KERNEL, MC_KERNEL
    from ldpc_tpu_torch.ops.metrics import ADD_COUNTERS, BATCH_COUNTERS
    from ldpc_tpu_torch.ops.qam_channel import QAM_CHANNEL
    from ldpc_tpu_torch.ops.qc_kernels import QC_KERNEL
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.results import SimulationResult
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code, run_simulation
    from ldpc_tpu_torch.utils import timing

    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    code = load_code(W1152)

    def sweep(tag, kind, batches, initial, end, step, via_fused=False, **kw):
        """``run_simulation`` over the points, its own per-point lines
        (FER, BER, codewords/s and info bits/s) in the log; K3 must launch
        once per batch and K1 / K2 never, or, ``via_fused``, K1 must launch
        and K3 never; K6 once per batch under QAM, else never; K7 and its
        add once per batch, as the run's ``batches`` counter has them."""
        opts = SimOptions(matrix=W1152, blocks=batches * BATCH, ber=True,
                          fer=True, fidelity="exact", speed=0.5, batch=BATCH,
                          seed=7, initial_snr=initial, end_snr=end,
                          step_snr=step,
                          output_json=str(out_dir / f"{tag}.json"), **kw)
        used = PointExecutor(code, opts).kernel_used
        log(f"{tag}: kernel_used {used}")
        if used != kind:
            fail(f"{tag} took {used}, expected {kind}")
        # warm: one batch of the same configuration (allocations, handles)
        run_simulation(SimOptions(**{**opts.__dict__, "blocks": BATCH,
                                     "end_snr": initial, "output_json": None,
                                     "quiet": True}), code)
        torch.cuda.synchronize()
        for k in (QC_KERNEL, MC_KERNEL, LLR_KERNEL, QAM_CHANNEL,
                  BATCH_COUNTERS, ADD_COUNTERS):
            k.launches = 0
        t0 = time.perf_counter()
        res = run_simulation(opts, code)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {"qc_decoder": QC_KERNEL.launches,
                    "mc_decoder": MC_KERNEL.launches,
                    "llr_decoder": LLR_KERNEL.launches,
                    "qam_channel": QAM_CHANNEL.launches,
                    "batch_counters": BATCH_COUNTERS.launches,
                    "add_counters": ADD_COUNTERS.launches}
        counted = timing.units(timing.RECORDER.spans,
                               "run_simulation")[-1][0].attrs["batches"]
        if (launches["batch_counters"], launches["add_counters"]) != \
                (counted,) * 2:
            fail(f"{tag}: batch_counters / add_counters launched "
                 f"{launches['batch_counters']} / {launches['add_counters']} "
                 f"times for {counted} batches")
        back = SimulationResult.from_json(str(out_dir / f"{tag}.json"))
        if [vars(p) for p in back.snr_points] != [vars(p) for p in res.snr_points]:
            fail(f"{tag}: the JSON read back differs from the result")
        n_batches = batches * len(res.snr_points)
        qam = kw.get("modulation", 1) in (4, 16, 64)
        if launches["qam_channel"] != (n_batches if qam else 0):
            fail(f"{tag}: qam_channel launched {launches['qam_channel']} "
                 f"times for {n_batches} batches")
        for p in res.snr_points:
            log(f"{tag} {p.snr_db:.2f} dB: FER {p.fer:.6f} "
                f"({p.failed_blocks}/{p.total_blocks}), BER {p.ber:.3e}, "
                f"avg conv {p.avg_convergence_iterations:.3f}")
        frames = sum(p.total_blocks for p in res.snr_points)
        log(f"{tag}: {frames} frames in {elapsed:.4f} s = "
            f"{frames / elapsed:.6g} codewords/s, "
            f"{frames * code.k / elapsed:.6g} info bits/s; device "
            f"{res.config.device}; launches {launches} over {n_batches} "
            "batches")
        if via_fused:
            if launches["mc_decoder"] < n_batches or launches["qc_decoder"]:
                fail(f"{tag}: the fused path launched {launches}")
            return res, launches, n_batches
        if launches["qc_decoder"] != n_batches:
            fail(f"{tag}: qc_decoder launched {launches['qc_decoder']} times "
                 f"for {n_batches} batches")
        if launches["mc_decoder"] or launches["llr_decoder"]:
            fail(f"{tag}: a fused kernel launched on the unfused path")
        return res, launches, n_batches

    # the headline: the burst-interleaver study's configuration at 1152
    head, head_launches, head_batches = sweep(
        "headline", "cuda+layered", QC_BATCHES, 5.0, 6.0, 0.5, **BURST)
    if len(head.snr_points) != 3:
        fail("the headline sweep did not run 3 points")
    fer6 = head.snr_points[-1].fer
    if not 0.0 < fer6 < head.snr_points[0].fer:
        fail(f"headline FER does not fall with SNR: "
             f"{[p.fer for p in head.snr_points]}")

    # the CLI's default schedule: flooding SPA-16, BPSK, through K3
    # (fused='off') and through the fused kernels (fused 'auto')
    flood, _, _ = sweep("flooding", "cuda", FLOOD_BATCHES, SNR_DB, SNR_DB,
                        1.0, schedule="flooding", decoder="sumproduct",
                        iterations=16, fused="off")
    sweep("flooding fused", "cuda+fused+2phase(auto)", FLOOD_BATCHES, SNR_DB,
          SNR_DB, 1.0, via_fused=True, schedule="flooding", decoder="sumproduct",
          iterations=16)
    sweep("flooding fused off", "cuda+fused", FLOOD_BATCHES, SNR_DB, SNR_DB,
          1.0, via_fused=True, schedule="flooding", decoder="sumproduct",
          iterations=16, two_phase="off")
    flooding_routes(code)
    pt = flood.snr_points[0]
    gap, bar = five_se(pt.failed_blocks, pt.total_blocks, REF_FLOOD)
    log(f"fer check flooding spa-16 2.0 dB: {pt.failed_blocks}/"
        f"{pt.total_blocks} = {pt.fer:.6f} vs TPU {REF_FLOOD[0]}/{REF_FLOOD[1]}"
        f" = {REF_FLOOD[0] / REF_FLOOD[1]:.6f}: |diff| {gap:.6f}, 5 se {bar:.6f}")
    if gap > bar:
        fail("flooding FER outside 5 combined standard errors of the TPU's")

    # the burst configuration at wimax 576, the study's own code
    w576 = load_code("builtin:wimax_576_0.5.alist.txt")
    opts = SimOptions(matrix=w576.name, blocks=QC_BATCHES * BATCH, fer=True,
                      fidelity="exact", speed=0.5, batch=BATCH, seed=9,
                      initial_snr=6.0, end_snr=6.0, quiet=True, **BURST)
    pt = run_simulation(opts, w576).snr_points[0]
    gap, bar = five_se(pt.failed_blocks, pt.total_blocks, REF_BURST)
    log(f"fer check burst wimax 576 6.0 dB: {pt.failed_blocks}/"
        f"{pt.total_blocks} = {pt.fer:.6f} vs TPU {REF_BURST[0]}/{REF_BURST[1]}"
        f" = {REF_BURST[0] / REF_BURST[1]:.6f}: |diff| {gap:.6f}, 5 se {bar:.6f}")
    if gap > bar:
        fail("burst FER outside 5 combined standard errors of the TPU's")
    return (head_launches["qc_decoder"], head_launches["qam_channel"],
            head_batches)


def flooding_routes(code) -> None:
    """Where the time of the flooding SPA-16 sweep goes on each route (K3
    through ``fused='off'``, fused ``--two-phase off``, fused ``auto``): the
    ``PointExecutor`` set-up (``auto`` measures the split's overhead there),
    a first ``run_point`` of the point's batches (``auto`` probes there) and
    a second on the same executor, each closed by a device sync."""
    import torch

    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor

    bits = FLOOD_BATCHES * BATCH * code.k
    for tag, kw in (("K3 fused=off", dict(fused="off")),
                    ("fused two_phase=off", dict(two_phase="off")),
                    ("fused two_phase=auto", {})):
        opts = SimOptions(matrix=W1152, fidelity="exact", speed=0.5,
                          batch=BATCH, seed=7, schedule="flooding",
                          decoder="sumproduct", iterations=16, quiet=True, **kw)
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        ex = PointExecutor(code, opts)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for _ in range(2):
            ex.run_point(SNR_DB, FLOOD_BATCHES * BATCH, 7, 0)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
        setup, first, second = (b - a for a, b in zip(t, t[1:]))
        log(f"flooding route {tag} ({ex.kernel_used}): set-up {setup:.5f} s, "
            f"first run_point {first:.5f} s ({bits / first:.6g} info bits/s), "
            f"second {second:.5f} s ({bits / second:.6g} info bits/s), "
            f"set-up + first {bits / (setup + first):.6g} info bits/s")


def phase_qc_timing(kept, peak: float):
    """Phase 9: K3 timed at 4096 frames beside its plain version and its
    bound. Returns {case: (ms, plain ms, bound ms, bound by, census ops)}."""
    import numpy as np

    from ldpc_tpu_torch.analysis.roofline import decode_work, init_census, lane_sweeps
    from ldpc_tpu_torch.ops.decode_loop import block_max_trips

    out = {}
    for tag, variant_iters in (("flooding spa-16", 16),
                               ("layered spa-12 serial (16-QAM)", 12)):
        dec, llr, o = kept[tag]
        qc = dec.qc
        B, n = llr.shape
        sw = lane_sweeps(o[1].cpu().numpy(), o[2].cpu().numpy(), variant_iters)
        ops = (decode_work(qc, dec.variant, dec.schedule, sweeps=sw,
                           check_every=dec.check_every,
                           track_norm=dec.track_norm)
               + B * init_census(qc).total())
        bound, by = bound_ms(ops, 4 * n * B + n * B + 13 * B, peak)
        ms = time_ms(lambda: dec.outputs(llr), reps=20)
        plain = time_ms(lambda: dec.plain_outputs(llr), reps=2, warm=1)
        # the sweeps a block runs: each codeword's own trips, against the
        # slowest of 8 in lockstep (the block of the first K3 design)
        lock = block_max_trips(o[1], o[2], 8, variant_iters)
        log(f"timing qc_decoder {tag} (B={B}): {ms:.4f} ms (plain {plain:.3f} "
            f"ms, bound {bound:.5f} ms by {by}, {ops:.6g} census ops, "
            f"{int(np.sum(sw))} lane sweeps; {plan_tag(dec.plan)}, "
            f"{dec.blocks_per_sm(llr.device)} blocks/SM; mean trips per "
            f"codeword {float(o[4].float().mean()):.4f}, {float(lock.float().mean()):.4f} "
            f"in lockstep blocks of 8)")
        out[tag] = (ms, plain, bound, by, ops)
    return out


def phase_unfused_split(smi: str) -> None:
    """Phase 9: one ``torch.profiler`` window of 16 unfused headline batches
    (the burst configuration at 5.5 dB, ``bench.device_breakdown``): K3's
    device ms per batch against the rest of the batch's device time, the
    batch's device busy time and span, and its host time without the
    profiler (CUDA-synchronised host clock over the same 16 batches)."""
    import torch

    from ldpc_tpu_torch.bench import device_breakdown
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code

    code = load_code(W1152)
    opts = SimOptions(matrix=W1152, blocks=QC_BATCHES * BATCH, ber=True,
                      fer=True, fidelity="exact", speed=0.5, batch=BATCH,
                      seed=7, **BURST)
    ex = PointExecutor(code, opts)
    span, busy, top = device_breakdown(ex, 5.5, batch=BATCH,
                                       n_batches=QC_BATCHES)
    ex.run_point(5.5, QC_BATCHES * BATCH, 7777, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.run_point(5.5, QC_BATCHES * BATCH, 7777, 0)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / QC_BATCHES
    if span is None:
        log(f"unfused batch split ({smi}): the profiler saw no device "
            f"events (not measured); host {wall:.4f} ms per batch")
        return
    k3 = sum(ms for name, ms, _ in top if "qc_decoder_kernel" in name)
    rest = sum(ms for name, ms, _ in top if "qc_decoder_kernel" not in name)
    per = 1.0 / QC_BATCHES
    log(f"unfused batch split ({smi}; headline 5.5 dB, {QC_BATCHES} batches "
        f"under torch.profiler): K3 {k3 * per:.4f} ms per batch, the rest "
        f"{rest * per:.4f} ms ({', '.join(f'{n[:40]} {ms * per:.4f}' for n, ms, _ in top[:6])}); "
        f"device busy {busy * per:.4f} ms, span {span * per:.4f} ms per "
        f"batch; without the profiler {wall:.4f} ms per batch on the host "
        f"clock (device busy {100 * busy * per / wall:.1f}% of it)")


# -------------------------------------------------------------- K4 and K5 ----

def hold_close(tag: str, kern, plain, exact: bool) -> float:
    """A probe's tile against its plain version's: bit for bit, or within
    rtol 1e-6. Returns the largest error."""
    import torch

    err = float((kern - plain).abs().max())
    same = float((kern == plain).float().mean())
    log(f"  {tag}: max |err| {err:.3g}, bit-equal share {same:.6f}")
    if not torch.isfinite(kern).all():
        fail(f"{tag} gave non-finite values")
    if exact and not torch.equal(kern, plain):
        fail(f"{tag} differs from its plain version")
    if not torch.allclose(kern, plain, rtol=1e-6, atol=0.0):
        fail(f"{tag} outside rtol 1e-6 of its plain version")
    return err


def phase_roofline(dev, smi: str, peak: float) -> dict:
    """Phase 10: K4 and K5 held and timed, and the roofline path through its
    two entry points. Returns the two kernels-line entries and the K5
    attainable census rate."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ldpc_tpu_torch.analysis.roofline import (
        CLASSES,
        _mix_schedule,
        full_occupancy_launch,
    )
    from ldpc_tpu_torch.ops.mc_kernels import LLR_KERNEL, MC_KERNEL
    from ldpc_tpu_torch.ops.rate_kernels import (
        MIX_KERNEL,
        OPS,
        OPS_PER_BODY,
        RATE_KERNEL,
        PIPES,
        UNROLL,
        MixChain,
        RateChain,
        instructions_per_body,
        library_hot_loops,
        pipe_bound,
        pipe_counts,
    )
    from ldpc_tpu_torch.scripts import attainable_ceiling, roofline

    blocks, threads = full_occupancy_launch(dev)
    gen = np.random.default_rng(5)

    def tile(launch):
        n = launch[0] * launch[1]
        return torch.from_numpy(gen.random((32, n // 32)).astype(np.float32)).to(dev)

    x = tile((blocks, threads))
    k4_loops = library_hot_loops("roofline")
    per_body = instructions_per_body(k4_loops)
    log("rate_chain hot-loop SASS instructions per body: "
        + ", ".join(f"{op} {per_body[op]:g}" for op in OPS))
    log(f"compare rate_chain (depth {COMPARE_DEPTH}, {blocks} blocks of "
        f"{threads}):")
    k4_err = 0.0
    for op in OPS:
        chain = RateChain(op, COMPARE_DEPTH)
        kern = chain(x)
        sync()
        k4_err = max(k4_err, hold_close(f"rate_chain {op}", kern, chain.plain(x),
                                        op in ("roll", "prng")))

    # ---- the roofline path, through its entry points ----
    out = Path(tempfile.mkdtemp(prefix="roofline-"))
    try:
        for k in (RATE_KERNEL, MIX_KERNEL, MC_KERNEL, LLR_KERNEL):
            k.launches = 0
        t0 = time.perf_counter()
        rc = roofline.main(["--bench-batches", str(ROOF_BENCH_BATCHES),
                            "--out", str(out)])
        rc = rc or attainable_ceiling.main(["--out", str(out)])
        sync()
        elapsed = time.perf_counter() - t0
        launches = {"rate_chain": RATE_KERNEL.launches,
                    "mix_rate": MIX_KERNEL.launches,
                    "mc_decoder": MC_KERNEL.launches,
                    "llr_decoder": LLR_KERNEL.launches}
        if rc:
            fail(f"the roofline path exited {rc}")
        roof = json.loads((out / "roofline.json").read_text())
        att = json.loads((out / "attainable.json").read_text())
    finally:
        shutil.rmtree(out, ignore_errors=True)
    log(f"roofline path: {elapsed:.1f} s, launches {launches}")
    for name in ("rate_chain", "mix_rate", "mc_decoder"):
        if launches[name] < 1:
            fail(f"{name} was not launched on the roofline path")

    # ---- its reports ----
    rates = {c: 1e9 * roof["measured_floor_gops"][c] for c in CLASSES}
    numbers = [*rates.values(), roof["ceiling_info_bits_per_s"],
               roof["floor_info_bits_per_s"],
               roof["single_pass_ceiling_info_bits_per_s"],
               roof["two_phase_ceiling_info_bits_per_s"],
               att["attainable_info_bits_per_s"],
               att["attainable_k1_launch_info_bits_per_s"]]
    if not all(math.isfinite(v) and v > 0 for v in numbers):
        fail(f"the roofline reports hold a value that is not finite and > 0: {numbers}")
    for c in CLASSES:
        log(f"rate {c:7s} {rates[c]:.6g} census ops/s ({smi})")
    for shape, key in (("full occupancy", "streams_ladder"),
                       ("K1's launch shape", "streams_ladder_k1_launch")):
        for s, r in att[key].items():
            log(f"ladder {shape} {r['launch'][0]}x{r['launch'][1]} "
                f"({r['blocks_per_sm']} blocks/SM) streams {s}: "
                f"{r['census_ops_per_s']:.6g} census ops/s ({smi})")
    if abs(roof["mean_tile_iters"] - roof["trip_model"]["single"]) > 1e-9:
        fail(f"block trips {roof['mean_tile_iters']} differ from the trip "
             f"model's {roof['trip_model']['single']}")
    frames = 3 * ROOF_BENCH_BATCHES * BATCH
    sigma = math.sqrt(REF_FER * (1 - REF_FER) / frames)
    achieved = roof["achieved_info_bits_per_s"]
    log(f"roofline at the bench point ({smi}): kernel {roof['kernel']}, "
        f"single-pass ceiling {roof['single_pass_ceiling_info_bits_per_s']:.6g}, "
        f"two-phase ceiling {roof['two_phase_ceiling_info_bits_per_s']:.6g}, "
        f"measured-floor bound {roof['floor_info_bits_per_s']:.6g}, attainable "
        f"{att['attainable_info_bits_per_s']:.6g} (at K1's launch shape "
        f"{att['attainable_k1_launch_info_bits_per_s']:.6g}), achieved "
        f"{achieved:.6g} info bits/s = {100 * roof['fraction_of_ceiling']:.3f}% "
        f"of the ceiling, {100 * att['fraction_of_attainable']:.3f}% of "
        f"attainable, {100 * achieved / roof['floor_info_bits_per_s']:.3f}% of "
        f"the floor; FER {roof['fer']:.6f} (ref {REF_FER}, 5 sigma "
        f"{5 * sigma:.6f}); issue peak {roof['issue_peak_ops_per_s']:.6g} op/s")
    if not 0 < roof["fraction_of_ceiling"] < 1:
        fail("the achieved rate is not below its ceiling")
    if roof["floor_info_bits_per_s"] >= roof["ceiling_info_bits_per_s"]:
        fail("the measured-floor bound is not below the issue-peak ceiling")
    if abs(roof["fer"] - REF_FER) > 5 * sigma:
        fail(f"roofline bench FER {roof['fer']:.6f} is more than 5 sigma from {REF_FER}")

    # ---- every K5 ladder entry against its plain version ----
    sched = _mix_schedule(att["frame_mix"])
    mix_err = 0.0
    log(f"compare mix_rate (schedule of {len(sched)} ops, 4 passes):")
    for key in ("streams_ladder", "streams_ladder_k1_launch"):
        for s, r in att[key].items():
            xm = tile(r["launch"])
            mix = MixChain(sched, int(s), 4, r["launch"][1])
            kern = mix(xm)
            sync()
            mix_err = max(mix_err, hold_close(
                f"mix_rate streams {s} {r['launch'][0]}x{r['launch'][1]}",
                kern, mix.plain(xm), False))

    # ---- K4 and K5 timed beside their plain versions and bounds ----
    elems = x.numel()
    chain = RateChain("fma", K4_TIME_DEPTH)
    hold_close(f"rate_chain fma depth {K4_TIME_DEPTH}", chain(x), chain.plain(x), True)
    k4_ms = time_ms(lambda: chain(x), reps=20)
    k4_plain = time_ms(lambda: chain.plain(x), reps=2, warm=1)
    mix = MixChain(sched, K5_TIME_STREAMS, K5_TIME_PASSES, threads)
    hold_close(f"mix_rate streams {K5_TIME_STREAMS} {K5_TIME_PASSES} passes",
               mix(x), mix.plain(x), False)
    k5_ms = time_ms(lambda: mix(x), reps=20)
    k5_plain = time_ms(lambda: mix.plain(x), reps=2, warm=1)
    # the bounds price the SASS of each hot loop by the pipes it loads
    # (ops.rate_kernels.pipe_bound: the issue term, every instruction at 128
    # a clock per SM, against each pipe's term at its compute capability
    # 9.0 rate). Both loops are unrolled, so the static count is the count
    # that runs, but for cosf's slow path, which the bench schedule lacks.
    # The census bound (OPS_PER_BODY, one instruction per retired census
    # op) stays beside it.
    k5_loop = library_hot_loops(("roofline", mix.defines))["mix_kernel"]
    for op in OPS:
        c = pipe_counts(k4_loops[f"rate_chain_{op}"])
        log(f"pipes rate_chain_{op} per body: "
            + ", ".join(f"{p} {c[p] / UNROLL:g}" for p in PIPES))
    k4_pipes = {p: v / UNROLL for p, v in
                pipe_counts(k4_loops["rate_chain_fma"]).items()}
    k5_pipes = {p: v / 2 for p, v in pipe_counts(k5_loop).items()}
    log(f"pipes mix_kernel per pass ({len(sched)} schedule ops, "
        f"{K5_TIME_STREAMS} streams): "
        + ", ".join(f"{p} {k5_pipes[p]:g}" for p in PIPES))

    def priced(pipes, units, census_ops):
        t_pipe, pipe, terms = pipe_bound(pipes, units, peak)
        b, by = bound_ms(t_pipe * peak, 8 * elems, peak)
        census, _ = bound_ms(census_ops, 8 * elems, peak)
        return b, by, pipe, terms, census

    k4_bound, k4_by, k4_pipe, k4_terms, k4_census = priced(
        k4_pipes, elems * K4_TIME_DEPTH,
        elems * K4_TIME_DEPTH * OPS_PER_BODY["fma"])
    retired = sum(OPS_PER_BODY[c] for c in sched)
    k5_bound, k5_by, k5_pipe, k5_terms, k5_census = priced(
        k5_pipes, elems * K5_TIME_PASSES, elems * K5_TIME_PASSES * retired)
    for tag, terms in (("rate_chain fma", k4_terms), ("mix_kernel", k5_terms)):
        log(f"pipe terms {tag} (ms): "
            + ", ".join(f"{p} {1e3 * t:.5f}" for p, t in terms.items()))
    log(f"timing ({smi}): rate_chain fma depth {K4_TIME_DEPTH} on {elems} "
        f"elements {k4_ms:.5f} ms (plain {k4_plain:.3f} ms, bound "
        f"{k4_bound:.5f} ms by {k4_by}, set by {k4_pipe}: "
        f"{100 * k4_bound / k4_ms:.1f}% of it; census bound {k4_census:.5f} "
        f"ms); mix_rate {K5_TIME_STREAMS} streams {K5_TIME_PASSES} passes "
        f"{k5_ms:.5f} ms (plain {k5_plain:.3f} ms, bound {k5_bound:.5f} ms by "
        f"{k5_by}, set by {k5_pipe}: {100 * k5_bound / k5_ms:.1f}% of it; "
        f"census bound {k5_census:.5f} ms at {retired} retired census ops "
        f"per pass of {len(sched)} schedule ops; "
        f"{sum(k5_pipes.values()):g} SASS instructions per pass)")
    return {
        "kernels": [
            {"name": "rate_chain", "route": "cuda", "source": ROOFLINE_SOURCE,
             "replaces": "ldpc_tpu/analysis/roofline.py:363",
             "launches": launches["rate_chain"], "max_abs_err": k4_err,
             "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bound,
             "bound_by": k4_by, "library_ms": None},
            {"name": "mix_rate", "route": "cuda", "source": ROOFLINE_SOURCE,
             "replaces": "ldpc_tpu/analysis/roofline.py:544",
             "launches": launches["mix_rate"], "max_abs_err": mix_err,
             "ms": k5_ms, "plain_ms": k5_plain, "bound_ms": k5_bound,
             "bound_by": k5_by, "library_ms": None},
        ],
        "attainable_census_ops_per_s": att["attainable_census_ops_per_s"],
    }



# ------------------------------------- the reference-fidelity path (plain) ----

W576 = "builtin:wimax_576_0.5.alist.txt"
REF_DEEP = (962, 400000)  # parity_runs/ours_deep.json: FER 0.002405 at 3.5 dB
CLI_BLOCKS = 102400
ADAPTIVE_RECORD = "examples/wimax576_adaptive/results.json"
ADAPTIVE_ARGS = ["--matrix", W576, "--adaptive", "--blocks", "20000",
                 "--iterations", "5", "--ber", "--fer", "--normalized-llr",
                 "--initial-snr", "0", "--end-snr", "5", "--step-snr", "1",
                 "--fidelity", "reference"]
PLAIN_BATCH = 512  # frames of the plain decoders held against the CPU


def qc_launches() -> dict:
    """The launch counts of the decode kernels K1-K3."""
    from ldpc_tpu_torch.ops.mc_kernels import LLR_KERNEL, MC_KERNEL
    from ldpc_tpu_torch.ops.qc_kernels import QC_KERNEL

    return {"mc_decoder": MC_KERNEL.launches,
            "llr_decoder": LLR_KERNEL.launches,
            "qc_decoder": QC_KERNEL.launches}


def zero_qc_launches() -> None:
    from ldpc_tpu_torch.ops.mc_kernels import LLR_KERNEL, MC_KERNEL
    from ldpc_tpu_torch.ops.qc_kernels import QC_KERNEL

    for k in (MC_KERNEL, LLR_KERNEL, QC_KERNEL):
        k.launches = 0


def run_cli(argv: list[str]) -> tuple[dict, float]:
    """``python -m ldpc_tpu_torch.cli`` in this process, its JSON written to
    a temporary directory and read back; returns it and the seconds the
    call took."""
    import shutil
    import tempfile

    import torch

    from ldpc_tpu_torch.cli import main as cli_main

    out = Path(tempfile.mkdtemp(prefix="cli-"))
    try:
        t0 = time.perf_counter()
        rc = cli_main(argv + ["--output-json", str(out / "r.json"), "--quiet"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if rc:
            fail(f"the CLI exited {rc} on {argv}")
        data = json.loads((out / "r.json").read_text())
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return data, seconds


def graph_llrs(code, graph: str, B: int, snr_db: float, seed: int, dev,
               noise_model: str = "legacy", speed: float = 1.0):
    """Channel LLRs (LLR > 0 <=> bit 1) of ``B`` random codewords in the
    ``graph`` domain, BPSK AWGN (``speed`` 1.0 is the CLI's default)."""
    import torch

    from ldpc_tpu_torch.ops.channel import ChannelParams, make_channel
    from ldpc_tpu_torch.ops.encode import make_encoder, random_info_bits

    gen = torch.Generator(device=dev).manual_seed(seed)
    u = random_info_bits(gen, B, code.k)
    w = make_encoder(code.standard_encode_spec, graph, dev)(u)
    params = ChannelParams(snr_db=snr_db, noise_model=noise_model, speed=speed)
    return make_channel(params, n=code.n, device=dev)(gen, w).contiguous()


def hold_plain(tag: str, dec, llr, exact: bool) -> None:
    """A plain decoder on the card against itself on the CPU, same LLRs:
    every output equal (``exact``: the min-sum family and bit-flipping), or
    est / ok / conv equal on at least 99% of frames (SPA: ``tanh`` and
    ``log`` differ by ulps between the two libraries)."""
    import copy

    import torch

    card = dec(llr)
    sync()
    cpu = copy.deepcopy(dec).to("cpu")(llr.cpu())
    same = (card.est.cpu() == cpu.est).all(dim=1) & (card.ok.cpu() == cpu.ok) \
        & (card.conv_iter.cpu() == cpu.conv_iter)
    frac = float(same.float().mean())
    norm_gap = float((card.norm_llr.cpu() - cpu.norm_llr).abs().max())
    iters = (int(card.iters_run), int(cpu.iters_run))
    log(f"  {tag}: frames equal {frac:.6f}, iters {iters[0]} / {iters[1]}, "
        f"norm max |diff| {norm_gap:g}, converged "
        f"{float(card.ok.float().mean()):.4f}")
    if exact and (frac != 1.0 or iters[0] != iters[1] or norm_gap != 0.0):
        fail(f"{tag}: the card differs from the CPU")
    if not exact and frac < 0.99:
        fail(f"{tag}: the card agrees with the CPU on {frac:.4f} of frames")
    if not torch.isfinite(card.norm_llr).all():
        fail(f"{tag}: non-finite outputs")


def phase_reference(dev, smi: str) -> None:
    """Phase 12: the CLI's default path (``--fidelity reference``: the std
    graph, the legacy check rule and noise) and the other plain decoders,
    none of which is a kernel."""
    import torch

    from ldpc_tpu_torch.ops.layered import make_qc_layered_decoder
    from ldpc_tpu_torch.ops.spa import make_decoder
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import load_code, run_simulation

    code = load_code(W576)
    k = code.k
    torch.cuda.synchronize(dev)  # the memory statistics need a context

    # ---- 12a. the CLI at its default fidelity ----
    zero_qc_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    d, secs = run_cli(["--matrix", W576, "--blocks", str(CLI_BLOCKS),
                       "--iterations", "5", "--ber", "--fer",
                       "--initial-snr", "3.5", "--end-snr", "3.5"])
    peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    run = qc_launches()
    cfg, p = d["config"], d["snr_points"][0]
    frames, errors = p["total_blocks"], p["failed_blocks"]
    gap, bar = five_se(errors, frames, REF_DEEP)
    log(f"CLI --fidelity reference ({smi}): wimax 576 SPA-5 3.5 dB, "
        f"{frames} frames (batch {cfg['batch'] or 'auto'}) in {secs:.3f} s = "
        f"{frames * k / secs:.6g} info bits/s (set-up included), FER "
        f"{p['fer']:.6f} (TPU record {REF_DEEP[0] / REF_DEEP[1]:.6f} of "
        f"{REF_DEEP[1]}, |diff| {gap:.6f}, 5 combined sigma {bar:.6f}), BER "
        f"{p['ber']:.4e}, peak memory {peak_gb:.3f} GB, graph "
        f"{cfg['decode_graph']}, rule {cfg['check_rule']}, noise "
        f"{cfg['noise_model']}, QC kernel launches {run}")
    if (cfg["decode_graph"], cfg["check_rule"], cfg["noise_model"]) != (
            "std", "legacy", "legacy"):
        fail(f"the CLI's default is not the reference fidelity: {cfg}")
    if frames != CLI_BLOCKS or any(run.values()):
        fail(f"the reference-fidelity CLI ran {frames} frames, launches {run}")
    if gap > bar:
        fail(f"reference-fidelity FER {p['fer']:.6f} is more than 5 sigma "
             f"from the TPU record")
    cli_fer = (errors, frames)

    # ---- 12b. the adaptive sweep of examples/wimax576_adaptive ----
    rec = json.loads((ROOT / ADAPTIVE_RECORD).read_text())
    d, secs = run_cli(ADAPTIVE_ARGS)
    log(f"CLI --adaptive ({smi}): 6 points x 20000 frames in {secs:.3f} s")
    for a, b in zip(d["snr_points"], rec["snr_points"]):
        gap, bar = five_se(a["failed_blocks"], a["total_blocks"],
                           (b["failed_blocks"], b["total_blocks"]))
        log(f"  {a['snr_db']:.1f} dB: FER {a['fer']:.6f} (TPU {b['fer']:.6f}, "
            f"|diff| {gap:.6f}, 5 sigma {bar:.6f}), BER {a['ber']:.4e} (TPU "
            f"{b['ber']:.4e}), interleaver {a['interleaver']}")
        if gap > bar:
            fail(f"adaptive FER at {a['snr_db']} dB is more than 5 sigma "
                 "from the TPU record")
    if d["adaptation_log"] != rec["adaptation_log"]:
        fail(f"the adaptation log differs from {ADAPTIVE_RECORD}: "
             f"{d['adaptation_log']}")
    log(f"  adaptation log equal to {ADAPTIVE_RECORD} "
        f"({len(rec['adaptation_log'])} entries)")

    # ---- 12c. one point each: R-U, bit-flipping, the layered plain decoder
    def point(tag, **kw):
        opts = SimOptions(matrix=W576, ber=True, fer=True, seed=3, quiet=True,
                          **kw)
        zero_qc_launches()
        t0 = time.perf_counter()
        res = run_simulation(opts, device=dev)
        secs = time.perf_counter() - t0
        q = res.snr_points[0]
        run = qc_launches()
        log(f"  {tag}: FER {q.fer:.6f} of {q.total_blocks}, BER {q.ber:.4e}, "
            f"{q.total_blocks * k / secs:.6g} info bits/s, launches {run}")
        if not (0.0 <= q.fer <= 1.0 and math.isfinite(q.ber)):
            fail(f"{tag}: FER {q.fer}, BER {q.ber}")
        return q, run

    log("one point each (wimax 576):")
    q, run = point("richardson-urbanke, reference fidelity, SPA-5 3.5 dB",
                   encoding_method="richardson-urbanke", blocks=4 * 8192,
                   iterations=5, initial_snr=3.5, end_snr=3.5)
    gap, bar = five_se(q.failed_blocks, q.total_blocks, cli_fer)
    if gap > bar or any(run.values()):
        fail(f"R-U FER {q.fer:.6f} is more than 5 sigma from the standard "
             f"encoder's {cli_fer[0] / cli_fer[1]:.6f} (or launches {run})")
    q, run = point("bit-flipping, exact fidelity, 20 it 6 dB",
                   decoder="bitflipping", fidelity="exact", blocks=8192,
                   iterations=20, initial_snr=6.0, end_snr=6.0)
    if q.fer >= 1.0 or any(run.values()):
        fail(f"bit-flipping at 6 dB: FER {q.fer}, launches {run}")
    lay = dict(fidelity="exact", decoder="normalized-minsum",
               schedule="layered", layer_order="paired", blocks=4 * 8192,
               iterations=8, initial_snr=2.0, end_snr=2.0, fused="off")
    qx, run_x = point("--kernel xla --schedule layered paired NMS-8 2 dB",
                      kernel="xla", **lay)
    qp, run_p = point("the same through K3 (--kernel pallas --fused off)",
                      kernel="pallas", **lay)
    if qx != qp or any(run_x.values()) or run_p["qc_decoder"] < 1:
        fail(f"layered plain decoder against K3: {qx} / {qp}, launches "
             f"{run_x} / {run_p}")

    # ---- 12d. the plain decoders on the card against the CPU ----
    log(f"plain decoders on the card against the CPU (B={PLAIN_BATCH}):")
    info = {g: code.standard_encode_spec.info_pos(g) for g in ("std", "orig")}
    llr_std = graph_llrs(code, "std", PLAIN_BATCH, 3.0, 11, dev)
    llr_orig = graph_llrs(code, "orig", PLAIN_BATCH, 2.0, 12, dev, "exact")
    for variant, exact in (("spa", False), ("normalized_minsum", True)):
        hold_plain(f"flooding std legacy {variant}-5",
                   make_decoder(code.layout("std"), info["std"], 5, variant,
                                rule="legacy", device=dev), llr_std, exact)
    for variant, exact in (("offset_minsum", True), ("spa", False)):
        hold_plain(f"flooding orig exact {variant}-8",
                   make_decoder(code.layout("orig"), info["orig"], 8, variant,
                                device=dev), llr_orig, exact)
    hold_plain("bit-flipping orig 20",
               make_decoder(code.layout("orig"), info["orig"], 20,
                            "bitflipping", device=dev), llr_orig, True)
    from ldpc_tpu_torch.models.qc import paired_layer_groups

    order = [bi for g in paired_layer_groups(code.qc) for bi in g]
    for variant, exact in (("normalized_minsum", True), ("spa", False)):
        hold_plain(f"layered paired {variant}-8",
                   make_qc_layered_decoder(code.qc, info["orig"], 8, variant,
                                           layer_order=order, device=dev),
                   llr_orig, exact)

    # ---- 12e. the plain decoders timed at the CLI's batch ----
    # std at the reference-fidelity point above; orig and layered at the
    # exact fidelity's waterfall (2.0 dB, exact noise, speed 1/2)
    log(f"plain decoders per batch ({smi}; SPA-5, auto batch):")
    for name in (W576, W1152):
        c = load_code(name)
        B = SimOptions(blocks=1 << 20).auto_batch(c.n)
        for graph, rule, snr, noise, speed in (
                ("std", "legacy", 3.5, "legacy", 1.0),
                ("orig", "exact", 2.0, "exact", 0.5),
                ("layered", "exact", 2.0, "exact", 0.5)):
            g = "orig" if graph == "layered" else graph
            llr = graph_llrs(c, g, B, snr, 21, dev, noise, speed)
            ipos = c.standard_encode_spec.info_pos(g)
            if graph == "layered":
                dec = make_qc_layered_decoder(c.qc, ipos, 5, "spa", device=dev)
            else:
                dec = make_decoder(c.layout(g), ipos, 5, "spa", rule=rule,
                                   device=dev)
            dec(llr)  # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            for _ in range(3):
                res = dec(llr)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 3 * 1e3
            peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
            lay = c.layout(g)
            log(f"  {c.name} {graph} ({rule} rule, {snr} dB {noise} noise; m "
                f"{lay.m}, dc {lay.dc}, dv {lay.dv}): B={B} {ms:.3f} ms per "
                f"batch = "
                f"{B * c.k / ms * 1e3:.6g} info bits/s, {int(res.iters_run)} "
                f"iterations, FER {1 - float(res.ok.float().mean()):.6f}, "
                f"peak memory {peak_gb:.3f} GB over the inputs")
            del llr, dec, res
            torch.cuda.empty_cache()

    # ---- 12f. where a plain batch's time goes (torch.profiler) ----
    from ldpc_tpu_torch.bench import device_breakdown
    from ldpc_tpu_torch.sim.runner import PointExecutor

    for tag, snr, kw in (
            ("reference fidelity, flooding std SPA-5", 3.5, {}),
            ("--kernel xla exact, flooding orig SPA-5", 2.0,
             dict(fidelity="exact", kernel="xla", speed=0.5))):
        opts = SimOptions(matrix=W576, iterations=5, ber=True, fer=True,
                          blocks=1 << 20, seed=5, quiet=True, **kw)
        ex = PointExecutor(code, opts, device=dev)
        B = ex.batch
        span, busy, top = device_breakdown(ex, snr, batch=B, n_batches=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.run_point(snr, 2 * B, 7777, 0)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / 2
        if span is None:
            log(f"plain batch split ({smi}; {tag}): the profiler saw no "
                f"device events (not measured); host {wall:.3f} ms a batch")
            continue
        log(f"plain batch split ({smi}; {tag}, wimax 576, B={B}, 2 batches "
            f"under torch.profiler): device busy {busy / 2:.3f} ms, span "
            f"{span / 2:.3f} ms a batch; host {wall:.3f} ms a batch without "
            f"the profiler (device busy {100 * busy / 2 / wall:.1f}% of it); "
            f"{sum(c for _, _, c in top) / 2:.0f} device kernels a batch; top: "
            + ", ".join(f"{n[:48]} {ms / 2:.3f} ms x{c // 2}"
                        for n, ms, c in top[:6]))


# ------------------------ the decoders' options: flooding, int8, alpha ----

# the JAX package's records for the fused kernels' new configurations
# (statistics of the code, not speeds): the learned [T] schedule at wimax
# 576, 2.0 dB (examples/learned_minsum/results.json, 0.15137 of 40,960), and
# int8 E, flooding normalized min-sum 20 iterations at wimax 1152, 2.0 dB
# (examples/quantized_messages/RESULTS.md, nms-int8msg 3.208e-02 of 40,000)
LEARNED = ROOT / "examples" / "learned_minsum" / "results.json"
REF_INT8 = (round(3.208e-2 * 40000), 40000)
FER_BATCHES = 16


def int8_ops(qc) -> float:
    """Census ops the int8 grid adds to a sweep of one frame: ``E_quantize``
    on each edge's one E write (clip 2, multiply, round, multiply back), in
    either schedule. The converts of E's reads and of its store are the
    int8 storage's, not the function's, and are not counted."""
    return 5 * sum(len(r) for r in qc.row_slots()) * qc.Z


def phase_fused_flooding(code, dev) -> dict:
    """Phase 4b: the fused flooding path (the CLI's default schedule), SPA-16
    at 2.0 dB, 64 batches of 4096, a single pass then the split forced at 8
    phase-1 sweeps; the launch counts zeroed just before each run and read
    just after (K1 in both, K2 in the split, K3 never); equal counters; the
    FER within 5 combined standard errors of the TPU's flooding record.
    Returns the launches."""
    import torch

    from ldpc_tpu_torch.ops.mc_kernels import LLR_KERNEL, MC_KERNEL
    from ldpc_tpu_torch.ops.qc_kernels import QC_KERNEL
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor

    runs, launches = {}, {"mc_decoder": 0, "llr_decoder": 0}
    for two_phase in ("off", "8"):
        ex = PointExecutor(code, SimOptions(
            matrix=code.name, iterations=16, fidelity="exact", batch=BATCH,
            seed=0, speed=0.5, schedule="flooding", decoder="sumproduct",
            two_phase=two_phase))
        ex.run_point(SNR_DB, BATCH, point_index=99)  # warm
        for kern in (MC_KERNEL, LLR_KERNEL, QC_KERNEL):
            kern.launches = 0
        t0 = time.perf_counter()
        st = ex.run_point(SNR_DB, FLOOD_BATCHES * BATCH)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        run = {"mc_decoder": MC_KERNEL.launches,
               "llr_decoder": LLR_KERNEL.launches,
               "qc_decoder": QC_KERNEL.launches}
        log(f"fused flooding spa-16 two_phase={two_phase}: {st.blocks} frames "
            f"in {elapsed:.4f} s = {st.blocks * code.k / elapsed:.6g} info "
            f"bits/s, FER {st.fer_frames / st.blocks:.6f}, kernel "
            f"{ex.kernel_used}, launches {run}")
        if run["mc_decoder"] < FLOOD_BATCHES or run["qc_decoder"] or (
                two_phase != "off" and run["llr_decoder"] < 1):
            fail(f"fused flooding {two_phase}: launches {run}")
        for name in launches:
            launches[name] += run[name]
        runs[two_phase] = st
    if runs["off"] != runs["8"]:
        fail(f"fused flooding: the dispatch modes disagree: {runs}")
    st = runs["off"]
    gap, bar = five_se(st.fer_frames, st.blocks, REF_FLOOD)
    log(f"fer check fused flooding spa-16 2.0 dB: {st.fer_frames}/{st.blocks} "
        f"= {st.fer_frames / st.blocks:.6f} vs TPU {REF_FLOOD[0]}/"
        f"{REF_FLOOD[1]}: |diff| {gap:.6f}, 5 se {bar:.6f}")
    if gap > bar:
        fail("fused flooding FER outside 5 combined standard errors of the TPU's")
    return launches


def timed(tag, call, plain, ops, nbytes, peak, blocks, out, reps=20):
    """Time a kernel call and its plain version; log and keep (ms, plain
    ms, bound ms, bound by, census ops, blocks/SM) under ``tag``."""
    ms = time_ms(call, reps=reps)
    pms = time_ms(plain, reps=2, warm=1)
    bound, by = bound_ms(ops, nbytes, peak)
    log(f"timing {tag}: {ms:.4f} ms (plain {pms:.3f} ms, bound {bound:.5f} ms "
        f"by {by}, {ops:.6g} census ops; {blocks} blocks/SM)")
    out[tag] = (ms, pms, bound, by, ops, blocks)


def phase_options_timing(code, dev, wT, consts, peak) -> dict:
    """Phase 5b: the new configurations of K1 / K2 / K3 held against their
    plain versions, then timed beside them and their bounds, with their
    resident blocks per SM: K1 flooding SPA-16 at 2.0 dB with and without
    the flip metric; K2 flooding on the
    split forced at 8; K1 layered paired NMS-12 ce2 with the scalar alpha,
    a [T] and a [T, D] schedule; K3 flooding NMS-16 with f32 and int8 E at
    WiMAX 1152 (4096 frames) and n=9216 (1024 frames)."""
    import torch

    from ldpc_tpu_torch.analysis.roofline import (
        channel_census,
        counter_census,
        decode_work,
        init_census,
        lane_sweeps,
    )
    from ldpc_tpu_torch.models.qc import paired_layer_groups
    from ldpc_tpu_torch.ops.mc_kernels import LLRDecoder, MCDecoder
    from ldpc_tpu_torch.sim.runner import load_code

    info = code.standard_encode_spec.info_pos("orig")
    n, B = code.n, wT.shape[1]
    key = (0x13198A2E, 0x03707344)
    out, err = {}, {"mc_decoder": 0.0, "llr_decoder": 0.0, "qc_decoder": 0.0}
    log("compare and time the decoders' options (wimax 1152, "
        f"B={B}):")

    def k1_ops(o, variant, schedule, max_it, ce=1, norm=False, q8=False):
        sw = lane_sweeps(o[1].cpu().numpy(), o[2].cpu().numpy(), max_it)
        ops = decode_work(code.qc, variant, schedule, sweeps=sw,
                          check_every=ce, track_norm=norm)
        ops += float(sw.sum()) * (int8_ops(code.qc) if q8 else 0)
        return ops + B * channel_census(code.qc).total()

    # K1 flooding SPA-16, with and without the flip metric
    for norm in (False, True):
        mc = MCDecoder(code.qc, info, 16, "spa", schedule="flooding",
                       track_norm=norm)
        tag = (f"mc_decoder flooding spa-16{' norm' if norm else ''} "
               f"({plan_tag(mc.plan)})")
        o, e = hold_mc(tag, mc, None, wT, consts, seeds=key)
        err["mc_decoder"] = max(err["mc_decoder"], e)
        timed(tag, lambda: mc(wT, consts, seeds=key),
              lambda: mc.plain(wT, consts, seeds=key),
              k1_ops(o, "spa", "flooding", 16, norm=norm),
              4 * n * B + 32 + 17 * B, peak, mc.blocks_per_sm(dev), out)

    # K2 flooding on the forced split (phase 1: 8 sweeps)
    mc1 = MCDecoder(code.qc, info, 8, "spa", schedule="flooding",
                    emit_llr=True)
    k2 = LLRDecoder(code.qc, info, 16, "spa", schedule="flooding")
    o1 = mc1(wT, consts, seeds=key)
    order = torch.argsort(o1[1].to(torch.int32), stable=True)
    llr_s = o1[5].index_select(1, order)
    w_s = wT.index_select(1, order)
    done0 = o1[1].index_select(0, order).to(torch.float32)
    o2 = k2(llr_s, w_s, done0)
    sync()
    tag = f"llr_decoder flooding spa-16 split at 8 ({plan_tag(k2.plan)})"
    err["llr_decoder"] = compare(tag, "spa", o2, k2.plain(llr_s, w_s, done0),
                                 "compacted phase 1")
    live = done0.cpu().numpy() < 0.5
    sw2 = lane_sweeps(o2[1].cpu().numpy()[live], o2[2].cpu().numpy()[live], 16)
    ops2 = decode_work(code.qc, "spa", "flooding", sweeps=sw2) + int(
        live.sum()) * (init_census(code.qc) + counter_census(code.qc)).total()
    timed(tag, lambda: k2(llr_s, w_s, done0),
          lambda: k2.plain(llr_s, w_s, done0), ops2,
          4 * n * 2 * int(live.sum()) + 21 * B, peak, k2.blocks_per_sm(dev),
          out)

    # K1 layered paired NMS-12 ce2: the scalar alpha, a [T], a [T, D]
    groups = paired_layer_groups(code.qc)
    for name, alpha in (("scalar 0.75", 0.75), ("[T]", ALPHA_T),
                        ("[T, D]", ALPHA_TD)):
        mc = MCDecoder(code.qc, info, ITERS, "normalized_minsum",
                       layer_groups=groups, check_every=CHECK_EVERY,
                       alpha=alpha)
        tag = f"mc_decoder layered paired nms-12 ce2 alpha {name}"
        o, e = hold_mc(tag, mc, None, wT, consts, seeds=key)
        err["mc_decoder"] = max(err["mc_decoder"], e)
        timed(tag, lambda: mc(wT, consts, seeds=key),
              lambda: mc.plain(wT, consts, seeds=key),
              k1_ops(o, "normalized_minsum", "layered", ITERS, ce=CHECK_EVERY),
              4 * n * B + 32 + 17 * B, peak, mc.blocks_per_sm(dev), out)

    # K3 flooding NMS-16, f32 and int8 E, at 1152 and n=9216
    big = load_code(str(ROOT / N9216))
    for c, batch, snr in ((code, BATCH, SNR_DB), (big, 1024, 1.5)):
        llr = channel_llrs(c, batch, snr, 21, dev)
        for store in ("f32", "int8"):
            dec = qc_decoder_for(c, "flooding", "serial", "normalized_minsum",
                                 16, 1, False, msg_store=store)
            tag = (f"qc_decoder flooding nms-16 {store} E n={c.n} B={batch} "
                   f"({plan_tag(dec.plan)})")
            o, e = hold_qc(tag, dec, llr)
            err["qc_decoder"] = max(err["qc_decoder"], e)
            sw = lane_sweeps(o[1].cpu().numpy(), o[2].cpu().numpy(), 16)
            ops = decode_work(c.qc, "normalized_minsum", "flooding",
                              sweeps=sw) + batch * init_census(c.qc).total()
            ops += float(sw.sum()) * (int8_ops(c.qc) if store == "int8" else 0)
            timed(tag, lambda: dec.outputs(llr), lambda: dec.plain_outputs(llr),
                  ops, 4 * c.n * batch + c.n * batch + 13 * batch, peak,
                  dec.blocks_per_sm(dev), out)
    return {"times": out, "errors": err}


def phase_fused_fer() -> None:
    """Phase 8b: FER of the fused kernels' new configurations against the
    JAX package's records, each within 5 combined standard errors: the
    learned [T] schedule through fused flooding NMS-12 at wimax 576, 2.0 dB;
    int8 E through fused flooding NMS-20 at wimax 1152, 2.0 dB."""
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code

    learned = json.loads(LEARNED.read_text())
    rec = learned["eval"][0]
    ref_learned = (round(rec["learned schedule"]["fer"]
                         * rec["learned schedule"]["frames"]),
                   rec["learned schedule"]["frames"])
    for tag, name, kw, ref in (
        ("learned schedule nms-12 wimax 576", "builtin:wimax_576_0.5.alist.txt",
         dict(iterations=12, minsum_alpha=tuple(learned["alphas"])),
         ref_learned),
        ("int8 E nms-20 wimax 1152", W1152,
         dict(iterations=20, msg_store="int8"), REF_INT8),
    ):
        code = load_code(name)
        ex = PointExecutor(code, SimOptions(
            matrix=name, fidelity="exact", batch=BATCH, seed=11, speed=0.5,
            schedule="flooding", decoder="normalized-minsum", **kw))
        if not ex.kernel_used.startswith("cuda+fused"):
            fail(f"{tag} took {ex.kernel_used}, not the fused kernels")
        st = ex.run_point(SNR_DB, FER_BATCHES * BATCH)
        gap, bar = five_se(st.fer_frames, st.blocks, ref)
        log(f"fer check fused flooding {tag} 2.0 dB ({ex.kernel_used}): "
            f"{st.fer_frames}/{st.blocks} = {st.fer_frames / st.blocks:.6f} vs "
            f"TPU {ref[0]}/{ref[1]} = {ref[0] / ref[1]:.6f}: |diff| {gap:.6f}, "
            f"5 se {bar:.6f}")
        if gap > bar:
            fail(f"{tag} FER outside 5 combined standard errors of the TPU's")
    scalar = rec["alpha=0.75 (default)"]["fer"]
    log(f"  (the scalar alpha 0.75 at this point: {scalar:.5f} on the TPU)")


# ------------------------------------ the parallel sweep and the analyses ----

CURVE = ROOT / "examples" / "error_floor" / "curve.json"
PROFILE_REC = ROOT / "examples" / "error_floor" / "failure_profile.json"
CENSUS_REC = ROOT / "examples" / "error_floor" / "trapping_census.json"
IS_REC = ROOT / "examples" / "error_floor" / "importance" / "results.json"
WITNESS_REC = ROOT / "examples" / "error_floor" / "undetected_codewords.json"
QUANT_REC = ROOT / "examples" / "quantized_messages" / "RESULTS.md"
BURST_REC = ROOT / "examples" / "burst_interleaver" / "results.json"
FAMILY_REC = ROOT / "examples" / "family_tpu" / "RESULTS.md"
PERF_REC = ROOT / "examples" / "perf_matrix" / "results.json"
# the error-floor study's decoder: layered SPA-12 serial at wimax 576, exact
# physics, Eb/N0 per info bit (scripts/error_floor.py)
FLOOR = dict(matrix="builtin:wimax_576_0.5.alist.txt", iterations=12,
             schedule="layered", decoder="sumproduct", fidelity="exact",
             exact_ber=True, speed=0.5, batch=BATCH, ber=True, fer=True,
             quiet=True)
PAR_SNRS = (2.0, 2.25, 2.5, 2.75)
PAR_BLOCKS = 64 * BATCH  # a point's cap; --target-errors 100 stops it first
RANK_TIMEOUT_S = 300
NO_OFFSET = ("const unsigned cw = C.cw0 + (unsigned)b;",
             "const unsigned cw = (unsigned)b;")


def start_no_offset_build() -> tuple:
    """Start ``nvcc`` on K1's source without the codeword offset (the
    earlier Philox counter, ``cw = b``), the same C interface, into
    ``build/chip_smoke``; returns (process, library path)."""
    from ldpc_tpu_torch.ops import build

    src = (ROOT / CSRC / "mc_decoder.cu").read_text()
    if src.count(NO_OFFSET[0]) != 1:
        fail("K1's source has no single codeword-offset line to take out")
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    variant = out_dir / "mc_decoder_no_offset.cu"
    variant.write_text(src.replace(*NO_OFFSET))
    lib = out_dir / "mc_decoder_no_offset.so"
    proc = subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(ROOT / CSRC), "-o",
         str(lib), str(variant)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, lib


def bind_library(kernel, path):
    """(fn, err) of ``kernel``'s C entry point in the library at ``path``,
    as ``build.Kernel`` binds its own."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    err = lib.cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def phase_k3_points(dev, smi: str, peak: float, rate: float) -> dict:
    """Phase 13a: K3 over S=4 points of the bench code (layered SPA-12
    paired ce2) in one launch of 4 x 4096 frames, through
    ``PointExecutor.sweep_step``: one launch, each point bit-equal to its
    single-point step, a skip mask [1,0,1,0] leaving points out (0 trips),
    the concatenated launch bit-equal to its plain version; then its ms per
    launch against 4 x the single-point ms, beside its plain version's ms,
    its bound (the census of the data's sweeps at the issue peak ``peak``,
    the LLRs in and the decisions out at 3.35 TB/s) and its attainable ms
    (the census at K5's rate ``rate``)."""
    import numpy as np
    import torch

    from ldpc_tpu_torch.analysis.roofline import (
        decode_work,
        init_census,
        lane_sweeps,
    )

    from ldpc_tpu_torch.ops.qc_kernels import QC_KERNEL
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, derive_key, load_code

    code = load_code(W1152)
    opts = SimOptions(matrix=W1152, iterations=ITERS, fidelity="exact",
                      speed=0.5, batch=BATCH, schedule="layered",
                      layer_order="paired", check_every=CHECK_EVERY,
                      fused="off")
    ex = PointExecutor(code, opts, step_vmapped=True)
    if ex.kernel_used != "cuda+layered+paired+ce2":
        fail(f"the sweep step took {ex.kernel_used}")
    snrs = (1.5, 2.0, 2.5, 3.0)
    consts = [ex.consts(s) for s in snrs]
    keys = [derive_key(5, i) for i in range(4)]
    out = {}
    for skips in ([0, 0, 0, 0], [1, 0, 1, 0]):
        QC_KERNEL.launches = 0
        stats, iters = ex.sweep_step(keys, consts, skips)
        sync()
        if QC_KERNEL.launches != 1:
            fail(f"the sweep step launched K3 {QC_KERNEL.launches} times")
        for i in range(4):
            if skips[i]:
                if int(iters[i]) != 0:
                    fail(f"skip-masked point {i} ran {int(iters[i])} trips")
                continue
            one, it = ex.step(keys[i], consts[i])
            if not all(torch.equal(a[i], b) for a, b in zip(stats, one)) \
                    or int(iters[i]) != int(it):
                fail(f"point {i} of the one launch differs from its own step")
        log(f"qc_decoder over 4 points, skips {skips}: one launch, each "
            f"point equal to its single-point launch, trips "
            f"{iters.tolist()}, FER {(~stats.ok).float().mean(1).tolist()}")
    # the launch itself, on the concatenated channel LLRs
    llrs = [ex._draw(keys[i], consts[i])[2] for i in range(4)]
    cat = torch.cat(llrs)
    dec = ex._decoder
    o, err = hold_qc(f"qc_decoder 4 points x {BATCH} in one launch "
                     f"({plan_tag(dec.plan)})", dec, cat)
    ms4 = time_ms(lambda: dec.outputs(cat), reps=10)
    ms1 = [time_ms(lambda x=x: dec.outputs(x), reps=10) for x in llrs]
    ms4b = time_ms(lambda: dec.outputs(cat), reps=10)
    plain = time_ms(lambda: dec.plain_outputs(cat), reps=2, warm=1)
    B, n = cat.shape
    sw = lane_sweeps(o[1].cpu().numpy(), o[2].cpu().numpy(), ITERS)
    ops = (decode_work(dec.qc, dec.variant, dec.schedule, sweeps=sw,
                       check_every=dec.check_every, track_norm=dec.track_norm)
           + B * init_census(dec.qc).total())
    bound, by = bound_ms(ops, 4 * n * B + n * B + 13 * B, peak)
    trips = [int(o[4][i * BATCH:(i + 1) * BATCH].max()) for i in range(4)]
    log(f"timing qc_decoder 4 points ({smi}): one launch of {B} "
        f"frames {ms4:.4f} / {ms4b:.4f} ms, the 4 single-point launches "
        f"{' + '.join(f'{m:.4f}' for m in ms1)} = {sum(ms1):.4f} ms; plain "
        f"{plain:.3f} ms, bound {bound:.5f} ms by {by} ({ops:.6g} census "
        f"ops, {int(np.sum(sw))} lane sweeps, trips by point {trips}), "
        f"attainable {1e3 * ops / rate:.5f} ms at K5's {rate:.6g} census "
        f"ops/s")
    out.update(err=err, ms4=min(ms4, ms4b), ms1=sum(ms1))
    return out


def phase_k1_offset(dev, smi: str, code, wT, consts, no_offset,
                    peak: float, rate: float) -> float:
    """Phase 13b: K1 with the codeword offset: two half launches (b0 = 0,
    B/2) bit-equal to the whole launch, LLRs included, and K1 (SPA-12, the
    main path's single pass) timed beside the build without the offset (the
    earlier counter), in turns, with its plain version's ms, its bound and
    its attainable ms (as phase 13a). Returns the largest error."""
    import numpy as np
    import torch

    from ldpc_tpu_torch.analysis.roofline import (
        channel_census,
        decode_work,
        lane_sweeps,
    )

    from ldpc_tpu_torch.models.qc import paired_layer_groups
    from ldpc_tpu_torch.ops.mc_kernels import MC_KERNEL, MCDecoder

    info_pos = code.standard_encode_spec.info_pos("orig")
    kw = dict(layer_groups=paired_layer_groups(code.qc),
              check_every=CHECK_EVERY)
    key = (0x243F6A88, 0x85A308D3)
    mc1 = MCDecoder(code.qc, info_pos, PHASE1, "spa", emit_llr=True, **kw)
    whole = mc1(wT, consts, seeds=key)
    half = BATCH // 2
    parts = [mc1(wT[:, lo:lo + half].contiguous(), consts, seeds=key, b0=lo)
             for lo in (0, half)]
    sync()
    for i, x in enumerate(whole):
        if not torch.equal(x, torch.cat([p[i] for p in parts], dim=-1)):
            fail(f"K1 halves with b0 differ from the whole launch (output {i})")
    plain = mc1.plain(wT[:, half:].contiguous(), consts, seeds=key, b0=half)
    err = float((parts[1][5] - plain[5]).abs().max())
    log(f"K1 codeword offset: halves b0=0 and b0={half} equal to the whole "
        f"launch ({BATCH} frames, LLRs included); the b0={half} half against "
        f"its plain version: LLR max |err| {err:.3g}")
    if err > 1e-4:
        fail("K1 with b0 outside the channel bar against its plain version")
    proc, lib = no_offset
    log_text, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"nvcc failed for K1 without the offset:\n{log_text}")
    mc = MCDecoder(code.qc, info_pos, ITERS, "spa", **kw)
    mc(wT, consts, seeds=key)  # binds the checkout's library
    own = MC_KERNEL._fns[()]
    before = bind_library(MC_KERNEL, lib)

    def timed(fns):
        MC_KERNEL._fns[()] = fns
        return time_ms(lambda: mc(wT, consts, seeds=key), reps=20)

    try:
        t = [timed(own), timed(before), timed(before), timed(own)]
    finally:
        MC_KERNEL._fns[()] = own
    t_own, t_before = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    o = mc(wT, consts, seeds=key)
    sw = lane_sweeps(o[1].cpu().numpy(), o[2].cpu().numpy(), ITERS)
    ops = (decode_work(code.qc, "spa", "layered", sweeps=sw,
                       check_every=CHECK_EVERY)
           + BATCH * channel_census(code.qc).total())
    bound, by = bound_ms(ops, 4 * code.n * BATCH + 32 + 17 * BATCH, peak)
    plain = time_ms(lambda: mc.plain(wT, consts, seeds=key), reps=2, warm=1)
    log(f"timing mc_decoder 12 it ({smi}): with the offset {t[0]:.4f} / "
        f"{t[3]:.4f} ms, without {t[1]:.4f} / {t[2]:.4f} ms: "
        f"{100 * (t_own / t_before - 1):+.2f}%; plain {plain:.3f} ms, bound "
        f"{bound:.5f} ms by {by} ({ops:.6g} census ops, {int(np.sum(sw))} "
        f"lane sweeps), attainable {1e3 * ops / rate:.5f} ms")
    return err


def phase_parallel_sweep(smi: str) -> None:
    """Phase 13c: ``run_simulation_parallel`` over the error-floor curve's
    first four points (layered SPA-12 at wimax 576, --exact-ber,
    --target-errors 100) on the card: K3 once per batch index, not once per
    point; every point's counters equal ``run_simulation(fused='off')``;
    each FER within 5 combined standard errors of ``curve.json``."""
    from dataclasses import replace

    import torch

    from ldpc_tpu_torch.ops.qc_kernels import QC_KERNEL
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import run_simulation, run_simulation_parallel

    kw = dict(FLOOR, blocks=PAR_BLOCKS, initial_snr=PAR_SNRS[0],
              end_snr=PAR_SNRS[-1], step_snr=0.25, target_errors=100, seed=0)
    rec = {p["snr_db"]: p for p in json.loads(CURVE.read_text())["snr_points"]}
    calls = {"parallel": run_simulation_parallel,
             "sequential fused=off":
                 lambda o: run_simulation(replace(o, fused="off"))}
    for call in calls.values():
        call(SimOptions(**dict(kw, blocks=BATCH)))  # warm: the same shapes
    runs = {}
    for tag in ("parallel", "sequential fused=off", "sequential fused=off",
                "parallel"):  # in turns
        QC_KERNEL.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = calls[tag](SimOptions(**kw))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        frames = sum(p.total_blocks for p in res.snr_points)
        log(f"{tag} sweep ({smi}): {len(res.snr_points)} points, {frames} "
            f"frames in {secs:.4f} s = {frames * 288 / secs:.6g} info bits/s, "
            f"{QC_KERNEL.launches} K3 launches")
        runs.setdefault(tag, (res, QC_KERNEL.launches))
    par, par_launches = runs["parallel"]
    seq, seq_launches = runs["sequential fused=off"]
    longest = max(p.total_blocks for p in par.snr_points) // BATCH
    if par_launches != longest or seq_launches <= par_launches:
        fail(f"the parallel sweep launched K3 {par_launches} times for "
             f"{longest} batch indices")
    for a, b in zip(par.snr_points, seq.snr_points):
        if vars(a) != vars(b):
            fail(f"parallel point {a.snr_db} != sequential: {vars(a)} "
                 f"{vars(b)}")
        r = rec[a.snr_db]
        gap, bar = five_se(a.failed_blocks, a.total_blocks,
                           (r["failed_blocks"], r["total_blocks"]))
        log(f"  {a.snr_db} dB: {a.failed_blocks}/{a.total_blocks} = "
            f"{a.fer:.6f} (equal to the sequential run) vs TPU "
            f"{r['failed_blocks']}/{r['total_blocks']} = {r['fer']:.6f}: "
            f"|diff| {gap:.6f}, 5 se {bar:.6f}")
        if a.failed_blocks < 100:
            fail(f"{a.snr_db} dB stopped before its 100 errors")
        if gap > bar:
            fail(f"{a.snr_db} dB FER outside 5 combined standard errors")


_RANK = r"""
import json, sys
import torch
from ldpc_tpu_torch.ops.mc_kernels import MC_KERNEL
from ldpc_tpu_torch.ops.qc_kernels import QC_KERNEL
from ldpc_tpu_torch.parallel.distributed import initialize_distributed, shutdown
from ldpc_tpu_torch.parallel.mesh import make_mesh
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.runner import (PointExecutor, load_code,
                                       run_simulation_parallel)

rank, port, out, kw = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                       json.loads(sys.argv[4]))
assert initialize_distributed(f"127.0.0.1:{port}", 2, rank)
mesh = make_mesh({"batch": 2})
res = {"backend": mesh.backend}
opts = SimOptions(**kw["point"])
ex = PointExecutor(load_code(opts.matrix), opts, mesh=mesh)
MC_KERNEL.launches = 0
st = ex.run_point(2.0, opts.blocks, 0, 0)
res["point"] = [ex.kernel_used, st.__dict__, MC_KERNEL.launches]
QC_KERNEL.launches = 0
par = run_simulation_parallel(SimOptions(**kw["sweep"]),
                              mesh=make_mesh({"snr": 2}))
res["sweep"] = [[vars(p) for p in par.snr_points], QC_KERNEL.launches]
from ldpc_tpu_torch import cli
assert cli.main(kw["cli"] + ["--output-json", out + ".json"]) == 0
res["cli"] = json.load(open(out + ".json"))["snr_points"]
json.dump(res, open(out, "w"))
shutdown()
"""


def phase_two_ranks(smi: str) -> None:
    """Phase 13d: two ranks on the one card over gloo (NCCL refuses two
    ranks on one GPU): the main path's point on a batch mesh (each rank K1
    on its half with its codeword offset), the parallel sweep on an snr=2
    mesh, and the CLI under ``--distributed --mesh batch=2``; the counters
    equal this process's unmeshed runs."""
    import tempfile

    from ldpc_tpu_torch.parallel.dryrun import free_port, run_ranks
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code, run_simulation

    point = dict(matrix=W1152, blocks=8 * BATCH, iterations=ITERS, ber=True,
                 fer=True, fidelity="exact", batch=BATCH, seed=0, speed=0.5,
                 schedule="layered", layer_order="paired",
                 check_every=CHECK_EVERY, quiet=True)
    sweep = dict(FLOOR, blocks=4 * BATCH, initial_snr=2.0, end_snr=2.75,
                 step_snr=0.25, seed=3)
    cli = ["--matrix", W1152, "--blocks", str(4 * BATCH), "--batch",
           str(BATCH), "--iterations", "12", "--ber", "--fer", "--fidelity",
           "exact", "--speed", "0.5", "--schedule", "layered",
           "--initial-snr", "1.5", "--end-snr", "2.0", "--step-snr", "0.5",
           "--quiet"]
    kw = {"point": point, "sweep": sweep,
          "cli": cli + ["--distributed", "--mesh", "batch=2"]}
    port = free_port()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [str(Path(tmp) / f"rank{r}.json") for r in range(2)]
        run_ranks(lambda r: [sys.executable, "-c", _RANK, str(r), str(port),
                             outs[r], json.dumps(kw)], 2, RANK_TIMEOUT_S)
        a, b = (json.loads(Path(o).read_text()) for o in outs)
        secs = time.perf_counter() - t0
        if a != b:
            fail("the two ranks disagree")
        one = PointExecutor(load_code(W1152), SimOptions(**point))
        st = one.run_point(2.0, point["blocks"], 0, 0)
        seq = run_simulation(SimOptions(**sweep, fused="off"))
        one_cli, _ = run_cli(cli)
    kernel, stats, k1 = a["point"]
    log(f"two ranks on one card ({smi}; backend {a['backend']}, "
        f"{secs:.1f} s with start-up): batch mesh point {kernel}, K1 "
        f"launches per rank {k1}, counters {stats}")
    if a["backend"] != "gloo":
        fail(f"two ranks on one card took backend {a['backend']}")
    if stats != st.__dict__:
        fail(f"the batch-mesh point differs from one process: {st.__dict__}")
    if k1 < 1:
        fail("the batch-mesh point did not launch K1")
    pts, k3 = a["sweep"]
    log(f"  snr=2 mesh sweep: {[(p['snr_db'], p['total_blocks'], p['failed_blocks']) for p in pts]}, "
        f"K3 launches per rank {k3}")
    if pts != [vars(p) for p in seq.snr_points]:
        fail("the snr-mesh sweep differs from the one-process fused=off run")
    if k3 < 1:
        fail("the snr-mesh sweep did not launch K3")
    keys = ("snr_db", "total_blocks", "successful_blocks", "ber", "fer")
    got = [[p[k] for k in keys] for p in a["cli"]]
    want = [[p[k] for k in keys] for p in one_cli["snr_points"]]
    log(f"  CLI --distributed --mesh batch=2: {got}")
    if got != want:
        fail(f"the CLI over two ranks differs from one process: {want}")


def phase_failure_profile(smi: str) -> None:
    """Phase 13e: the CLI's ``--failure-profile`` at 3.5 dB (the sweep
    stops at 100 frame errors, the profile at 100 detected failures)
    against ``failure_profile.json``'s 303 / 17,793,024, within 5 combined
    standard errors; then a census of 128 failure patterns at the census
    record's SNR."""
    import tempfile

    import numpy as np

    from ldpc_tpu_torch.analysis.failures import (
        collect_failure_patterns,
        trapping_census,
    )
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import load_code

    rec = json.loads(PROFILE_REC.read_text())["3.5"]
    ref = (rec["detected"]["count"], rec["frames"])
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "fp.json"
        t0 = time.perf_counter()
        d, _ = run_cli(["--matrix", FLOOR["matrix"], "--blocks",
                        str(4096 * BATCH), "--batch", str(BATCH),
                        "--iterations", "12", "--schedule", "layered",
                        "--fidelity", "exact", "--exact-ber", "--speed", "0.5",
                        "--ber", "--fer", "--initial-snr", "3.5",
                        "--end-snr", "3.5", "--target-errors", "100",
                        "--failure-profile", str(path)])
        secs = time.perf_counter() - t0
        prof = json.loads(path.read_text())["3.5"]
    det, frames = prof["detected"]["count"], prof["frames"]
    gap, bar = five_se(det, frames, ref)
    log(f"--failure-profile 3.5 dB ({smi}; {secs:.2f} s, the sweep's "
        f"{d['snr_points'][0]['total_blocks']} frames included): {det} "
        f"detected / {frames} = {det / frames:.4e}, undetected "
        f"{prof['undetected']['count']}, median weight "
        f"{prof['detected'].get('median')} vs TPU {ref[0]}/{ref[1]} = "
        f"{ref[0] / ref[1]:.4e} (median {rec['detected']['median']}): "
        f"|diff| {gap:.3e}, 5 se {bar:.3e}")
    if det < 100:
        fail(f"the failure profile stopped at {det} detected failures")
    if gap > bar:
        fail("the detected-failure rate is outside 5 combined standard errors")
    census_snr = json.loads(CENSUS_REC.read_text())["snr_db"]
    code = load_code(FLOOR["matrix"])
    popts = SimOptions(**dict(FLOOR, fused="off", seed=0))
    t0 = time.perf_counter()
    pats, seen, frames = collect_failure_patterns(
        code, popts, census_snr, min_patterns=128, max_blocks=2048 * BATCH,
        max_patterns=128, say=lambda *a, **k: None)
    census = trapping_census(pats, code)
    secs = time.perf_counter() - t0
    top = list(census["classes"].items())[:5]
    log(f"census at {census_snr} dB ({smi}; {secs:.2f} s): {len(pats)} "
        f"patterns of {seen} failures in {frames} frames, top (a,b) classes "
        f"{top}, {len(census['recurring_supports'])} recurring supports")
    if len(pats) < 128 or not np.all(pats.sum(axis=1) > 0):
        fail(f"the census captured {len(pats)} patterns")


def phase_importance(smi: str) -> None:
    """Phase 13f: ``estimate_point`` at 3.5 dB with the record's 6 codeword
    and 10 trapping supports (192 orbit components) over the record's
    frames, against its validation FER within 5 combined sigma."""
    from ldpc_tpu_torch.analysis.importance import estimate_point, orbit_supports
    from ldpc_tpu_torch.ops.qc_kernels import QC_KERNEL
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import load_code

    rec = json.loads(IS_REC.read_text())
    val = next(v for v in rec["validation"] if v["snr_db"] == 3.5)
    code = load_code(FLOOR["matrix"])
    shifts = orbit_supports(rec["codeword_supports"] + rec["trapping_supports"],
                            code.qc.Z, code.n, max_components=1024)
    if shifts.shape[0] != rec["components"]:
        fail(f"{shifts.shape[0]} mixture components, the record has "
             f"{rec['components']}")
    opts = SimOptions(**dict(FLOOR, fused="off", blocks=BATCH, seed=0))
    QC_KERNEL.launches = 0
    t0 = time.perf_counter()
    r = estimate_point(code, opts, 3.5, shifts, frames=val["frames"],
                       pi0=rec["pi0"], shift=rec["shift"])
    secs = time.perf_counter() - t0
    bar = 5 * math.hypot(r.fer_std, val["fer_std"])
    log(f"importance sampling 3.5 dB ({smi}; {secs:.2f} s, {r.frames} frames, "
        f"{QC_KERNEL.launches} K3 launches): FER {r.fer:.4e} +- "
        f"{r.fer_std:.2e} vs TPU {val['fer']:.4e} +- {val['fer_std']:.2e} "
        f"(|diff| {abs(r.fer - val['fer']):.2e}, 5 combined sigma {bar:.2e}); "
        f"undetected {r.undetected:.4e} (TPU {val['undetected']:.4e}); "
        f"E[w] {r.mean_weight:.5f}, max w {r.max_weight:.3f}")
    if QC_KERNEL.launches < 1:
        fail("the importance sampler did not run through K3")
    if r.max_weight > 1.0 / rec["pi0"] + 1e-6 or abs(r.mean_weight - 1) > 0.01:
        fail("importance weights out of their bounds")
    if abs(r.fer - val["fer"]) > bar:
        fail("the IS FER is outside 5 combined sigma of the record")


def phase_learned(smi: str) -> None:
    """Phase 13g: the recorded learned [12] schedule through
    ``evaluate_alphas`` at 2.5 dB over 40,960 frames against the record
    within 5 combined sigma; 20 steps of ``train_alphas`` whose loss on a
    held-out batch falls."""
    import torch

    from ldpc_tpu_torch.analysis.learned_minsum import (
        evaluate_alphas,
        make_unrolled_minsum,
        multiloss,
        train_alphas,
    )
    from ldpc_tpu_torch.ops.channel import ChannelParams, make_channel_fn
    from ldpc_tpu_torch.ops.encode import make_encoder, random_info_bits
    from ldpc_tpu_torch.sim.runner import load_code

    learned = json.loads(LEARNED.read_text())
    rec = next(e for e in learned["eval"] if e["snr_db"] == 2.5)
    ref = rec["learned schedule"]
    code = load_code(FLOOR["matrix"])
    t0 = time.perf_counter()
    r = evaluate_alphas(code, learned["alphas"], 2.5, 12, blocks=ref["frames"],
                        batch=BATCH)
    secs = time.perf_counter() - t0
    gap, bar = five_se(round(r["fer"] * r["frames"]), r["frames"],
                       (round(ref["fer"] * ref["frames"]), ref["frames"]))
    log(f"evaluate_alphas learned [12] 2.5 dB ({smi}; {secs:.2f} s): FER "
        f"{r['fer']:.5f} of {r['frames']} vs TPU {ref['fer']:.5f}: |diff| "
        f"{gap:.5f}, 5 se {bar:.5f}")
    if r["frames"] != ref["frames"] or gap > bar:
        fail("the learned schedule's FER is outside 5 combined sigma")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    alphas, losses = train_alphas(code, 2.0, 12, steps=20, batch=128,
                                  say=lambda *a, **k: None)
    secs = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(99)
    u = random_info_bits(gen, 1024, code.k)
    w = make_encoder(code.standard_encode_spec, "orig", dev)(u)
    consts = ChannelParams(speed=0.5, snr_db=2.0,
                           noise_model="exact").consts(dev)
    llr = make_channel_fn(1, 1, n=code.n)(gen, w, consts)
    unrolled = make_unrolled_minsum(code.layout("orig"), 12)
    with torch.no_grad():
        before = float(multiloss(unrolled(torch.full((12,), 0.75, device=dev),
                                          llr), w))
        after = float(multiloss(unrolled(torch.as_tensor(alphas, device=dev),
                                         llr), w))
    log(f"train_alphas 20 steps ({smi}; {secs:.2f} s): held-out loss "
        f"{before:.5f} -> {after:.5f}, alphas {[round(a, 4) for a in alphas.tolist()]}")
    if not after < before:
        fail("20 steps of train_alphas did not lower the held-out loss")


# ------------------------------------------------ the repo-level studies ----

STUDY_ECHO_LINES = 12  # the last lines of a study's own output, echoed


def kernel_counts() -> dict:
    from ldpc_tpu_torch.ops.mc_kernels import LLR_KERNEL, MC_KERNEL
    from ldpc_tpu_torch.ops.qc_kernels import QC_KERNEL

    return {"mc_decoder": MC_KERNEL.launches, "llr_decoder": LLR_KERNEL.launches,
            "qc_decoder": QC_KERNEL.launches}


def zero_kernel_counts() -> None:
    from ldpc_tpu_torch.ops.mc_kernels import LLR_KERNEL, MC_KERNEL
    from ldpc_tpu_torch.ops.qc_kernels import QC_KERNEL

    MC_KERNEL.launches = LLR_KERNEL.launches = QC_KERNEL.launches = 0


class Studies:
    """The bookkeeping of phases 14 and 15: each study runs with the launch
    counts zeroed just before it and read just after, its own output
    captured (its last lines echoed), and one summary row per comparison
    against its record."""

    def __init__(self, smi: str):
        self.smi = smi
        self.rows: list[tuple[str, str, str, str]] = []
        self.launches: dict[str, int] = {}

    def run(self, tag: str, call, needs: tuple[str, ...] = (),
            none_of: tuple[str, ...] = ()):
        import contextlib
        import io

        buf = io.StringIO()
        zero_kernel_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                out = call()
        except BaseException:
            log(buf.getvalue())
            raise
        secs = time.perf_counter() - t0
        counts = kernel_counts()
        for line in buf.getvalue().splitlines()[-STUDY_ECHO_LINES:]:
            log(f"    | {line}")
        log(f"  {tag}: {secs:.2f} s, launches {counts}")
        for name in needs:
            if counts[name] < 1:
                fail(f"{tag} never launched {name}")
        for name in none_of:
            if counts[name]:
                fail(f"{tag} launched {name} {counts[name]} times")
        for name, c in counts.items():
            self.launches[name] = self.launches.get(name, 0) + c
        return out

    def fer(self, study: str, what: str, errors: int, frames: int,
            ref: tuple[int, int]) -> None:
        """A frame-error rate against its TPU record, within 5 combined
        standard errors."""
        gap, bar = five_se(errors, frames, ref)
        ok = gap <= bar
        self.rows.append((study, f"{what}: {errors} / {frames} = "
                          f"{errors / frames:.4e}", f"{ref[0]} / {ref[1]} = "
                          f"{ref[0] / ref[1]:.4e}",
                          f"{'within' if ok else 'OUTSIDE'} 5 se "
                          f"(|diff| {gap:.3e}, 5 se {bar:.3e})"))
        log(f"  {study} {what}: {errors} / {frames} = {errors / frames:.4e} "
            f"vs TPU {ref[0]} / {ref[1]} = {ref[0] / ref[1]:.4e}: |diff| "
            f"{gap:.3e}, 5 se {bar:.3e}")
        if not ok:
            fail(f"{study} {what} is outside 5 combined standard errors")

    def equal(self, study: str, what: str, ours, theirs,
              against: str = "the record's") -> None:
        """An output with no randomness, equal to the record's (or to
        ``against``)."""
        self.rows.append((study, what, against, "equal"
                          if ours == theirs else "DIFFERENT"))
        log(f"  {study} {what}: {'equal' if ours == theirs else 'DIFFERENT'}")
        if ours != theirs:
            fail(f"{study}: {what} differs from the record: {ours!r} != "
                 f"{theirs!r}")


def md_table(text: str, first_cell: str) -> dict[str, list[str]]:
    """The rows of the first markdown table of ``text`` whose header starts
    with ``| first_cell |``: {first cell: the other cells}."""
    from ldpc_tpu_torch.scripts.study import md_rows

    return {c[0]: c[1:] for c in md_rows(text, f"| {first_cell} |")}


def study_error_floor(st: Studies, tmp: Path) -> None:
    """The curve at 2.0-2.5 dB (--target-errors 50, K1) and the failure
    profile at 3.0 dB (50 detected failures, K3) against ``curve.json``;
    the census classes of the census record's recurring supports equal
    its own."""
    import numpy as np

    from ldpc_tpu_torch.analysis.failures import trapping_census
    from ldpc_tpu_torch.scripts import error_floor
    from ldpc_tpu_torch.sim.runner import load_code

    curve_rec = json.loads(CURVE.read_text())
    ref = {p["snr_db"]: p for p in curve_rec["snr_points"]}
    out = tmp / "error_floor"
    st.run("error floor curve", lambda: error_floor.main(
        ["--snr", "2.0:2.5:0.25", "--target-errors", "50", "--skip-profile",
         "--out", str(out)]), needs=("mc_decoder",), none_of=("qc_decoder",))
    curve = json.loads((out / "curve.json").read_text())
    st.equal("error floor", "curve.json keys", sorted(curve),
             sorted(curve_rec))
    for p in curve["snr_points"]:
        r = ref[p["snr_db"]]
        st.fer("error floor", f"curve {p['snr_db']} dB", p["failed_blocks"],
               p["total_blocks"], (r["failed_blocks"], r["total_blocks"]))
    st.run("error floor profile", lambda: error_floor.main(
        ["--skip-curve", "--profile-snrs", "3.0", "--profile-errors", "50",
         "--out", str(out)]), needs=("qc_decoder",), none_of=("mc_decoder",))
    prof = json.loads((out / "failure_profile.json").read_text())["3.0"]
    st.equal("error floor", "failure_profile.json keys", sorted(prof),
             sorted(json.loads(PROFILE_REC.read_text())["3.5"]))
    r = ref[3.0]
    fails = prof["detected"]["count"] + prof["undetected"]["count"]
    st.fer("error floor", "profile 3.0 dB (detected + undetected)", fails,
           prof["frames"], (r["failed_blocks"], r["total_blocks"]))
    census_rec = json.loads(CENSUS_REC.read_text())
    code = load_code(FLOOR["matrix"])
    pats = []
    for entry in census_rec["recurring_supports"]:
        e = np.zeros(code.n, np.uint8)
        e[entry["support"]] = 1
        pats += [e] * entry["count"]
    census = trapping_census(np.stack(pats), code)
    st.equal("error floor", "census of the record's recurring supports",
             [(s["support"], s["count"], s["a"])
              for s in census["recurring_supports"]],
             [(s["support"], s["count"], s["a"])
              for s in census_rec["recurring_supports"]])
    st.equal("error floor", "their (a,b) classes among the record's",
             set(census["classes"]) <= set(census_rec["classes"]), True)


def study_witness(st: Studies, tmp: Path) -> None:
    """Undetected residuals at wimax 576, 2.5 dB: each a nonzero codeword of
    weight >= 13, each weight-13 one in the orbit of the importance record's
    codeword supports; the event rate against the record's 8 / 229,376."""
    import numpy as np

    from ldpc_tpu_torch.models.qc import qc_orbit_canonical
    from ldpc_tpu_torch.scripts import undetected_witness
    from ldpc_tpu_torch.sim.runner import load_code

    rec = json.loads(WITNESS_REC.read_text())
    path = tmp / "witness" / "undetected_codewords.json"
    st.run("undetected witness", lambda: undetected_witness.main(
        ["--code", FLOOR["matrix"], "--snrs", "2.5", "--min-patterns", "2",
         "--out", str(path)]), needs=("qc_decoder",))
    out = json.loads(path.read_text())
    code = load_code(FLOOR["matrix"])
    events = out["points"][0]["events"]
    if len(events) < 2:
        fail(f"the witness study captured {len(events)} events")
    for e in events:
        word = np.zeros(code.n, np.uint8)
        word[e["support"]] = 1
        if not e["is_codeword"] or code.syndrome_orig(word).any() \
                or e["weight"] < min(rec["codeword_weights"]):
            fail(f"witness residual of weight {e['weight']} is not a "
                 f"codeword of weight >= 13")
    Z = code.qc.Z
    known = {qc_orbit_canonical(s, Z) for s in json.loads(
        IS_REC.read_text())["codeword_supports"] if len(s) == 13}
    keys13 = {qc_orbit_canonical(e["support"], Z) for e in events
              if e["weight"] == 13}
    st.equal("undetected witness", f"weights {sorted(e['weight'] for e in events)}"
             f" all codewords, the weight-13 orbit keys ({len(keys13)})",
             keys13 <= known, True)
    p = out["points"][0]
    st.fer("undetected witness", "undetected events at 2.5 dB",
           p["events_seen"], p["frames"], (rec["events"], rec["frames"]))


def study_importance(st: Studies, tmp: Path) -> None:
    """The importance study's capture and one validation point, 3.5 dB, over
    the record's frames, against ``importance/results.json``."""
    from ldpc_tpu_torch.scripts import importance_floor

    rec = json.loads(IS_REC.read_text())
    val = next(v for v in rec["validation"] if v["snr_db"] == 3.5)
    out = tmp / "importance"
    st.run("importance floor", lambda: importance_floor.main(
        ["--census", str(CENSUS_REC), "--validate-snrs", "3.5",
         "--deep-snrs", "", "--validate-frames", str(val["frames"]),
         "--out", str(out)]), needs=("qc_decoder",))
    res = json.loads((out / "results.json").read_text())
    st.equal("importance floor", "results.json keys", sorted(res), sorted(rec))
    st.equal("importance floor", "trapping supports from the census",
             res["trapping_supports"], rec["trapping_supports"])
    r = res["validation"][0]
    bar = 5 * math.hypot(r["fer_std"], val["fer_std"])
    gap = abs(r["fer"] - val["fer"])
    ok = gap <= bar
    st.rows.append(("importance floor", f"FER 3.5 dB {r['fer']:.4e} +- "
                    f"{r['fer_std']:.2e} ({r['frames']} frames, "
                    f"{res['components']} components)",
                    f"{val['fer']:.4e} +- {val['fer_std']:.2e}",
                    f"{'within' if ok else 'OUTSIDE'} 5 sigma (|diff| "
                    f"{gap:.2e}, 5 sigma {bar:.2e})"))
    log(f"  importance floor 3.5 dB: FER {r['fer']:.4e} +- {r['fer_std']:.2e}"
        f" vs TPU {val['fer']:.4e} +- {val['fer_std']:.2e}: |diff| "
        f"{gap:.2e}, 5 combined sigma {bar:.2e}")
    if not ok:
        fail("the importance floor's FER is outside 5 combined sigma")


def study_precision(st: Studies, tmp: Path) -> None:
    """The five message-precision variants at 2.0 and 2.5 dB, 4096 frames
    each, against ``quantized_messages/RESULTS.md`` (40,000 frames)."""
    from ldpc_tpu_torch.scripts import quantized_messages_study

    path = tmp / "quantized" / "RESULTS.md"
    st.run("message precision", lambda: quantized_messages_study.main(
        ["--blocks", "4096", "--snrs", "2.0,2.5", "--out", str(path)]),
        none_of=("mc_decoder", "llr_decoder", "qc_decoder"))
    head = "Eb/N0 (dB)"
    ours = md_table(path.read_text(), head)
    ref = md_table(QUANT_REC.read_text(), head)
    names = list(quantized_messages_study.VARIANTS)
    for snr in ("2.0", "2.5"):
        for name, a, b in zip(names, ours[snr], ref[snr]):
            st.fer("message precision", f"{name} {snr} dB",
                   round(float(a) * 4096), 4096,
                   (round(float(b) * 40000), 40000))


def study_burst(st: Studies, tmp: Path) -> None:
    """The burst study at 5.75 dB, target 100, rows none / regular /
    random / srandom S=2 / adversarial, against ``burst_interleaver/
    results.json``; the adversarial permutation equal to the committed
    one."""
    import numpy as np

    from ldpc_tpu_torch.scripts import burst_interleaver_study

    rec = json.loads(BURST_REC.read_text())
    out = tmp / "burst"
    st.run("burst interleaver", lambda: burst_interleaver_study.main(
        ["--snr", "5.75", "--target-errors", "100", "--s-sweep", "2",
         "--out", str(out)]), needs=("qc_decoder",))
    st.equal("burst interleaver", "adversarial_pi.npy",
             np.load(out / "adversarial_pi.npy").tolist(),
             np.load(BURST_REC.parent / "adversarial_pi.npy").tolist())
    res = json.loads((out / "results.json").read_text())
    for label, row in res["rows"].items():
        a, b = row["5.75"], rec["rows"][label]["5.75"]
        st.fer("burst interleaver", f"{label} 5.75 dB", a["errors"],
               a["blocks"], (b["errors"], b["blocks"]))


def study_learned(st: Studies, tmp: Path) -> None:
    """The learned min-sum study, 20 steps, 4096 evaluation frames; the
    fixed-alpha columns against ``learned_minsum/results.json``."""
    from ldpc_tpu_torch.scripts import learned_minsum_study

    rec = json.loads(LEARNED.read_text())
    out = tmp / "learned"
    st.run("learned min-sum", lambda: learned_minsum_study.main(
        ["--steps", "20", "--eval-blocks", "4096", "--out", str(out)]),
        none_of=("mc_decoder", "llr_decoder", "qc_decoder"))
    res = json.loads((out / "results.json").read_text())
    st.equal("learned min-sum", "results.json keys", sorted(res), sorted(rec))
    for row, ref in zip(res["eval"], rec["eval"]):
        for name in ("alpha=0.75 (default)", "alpha=0.8125"):
            a, b = row[name], ref[name]
            st.fer("learned min-sum", f"{name} {row['snr_db']} dB",
                   round(a["fer"] * a["frames"]), a["frames"],
                   (round(b["fer"] * b["frames"]), b["frames"]))


def study_parity(st: Studies, tmp: Path) -> None:
    """The exact-noise replay (5 reps) against ``parity_runs/
    fixed_noise.json`` and the spread (3 reps) against ``spread.json``."""
    from ldpc_tpu_torch.scripts import parity_fixed_noise, parity_spread

    path = tmp / "parity" / "fixed_noise.json"
    st.run("parity fixed noise", lambda: parity_fixed_noise.main(
        ["--reps", "5", "--out", str(path)]),
        none_of=("mc_decoder", "llr_decoder", "qc_decoder"))
    rec = json.loads((ROOT / "parity_runs" / "fixed_noise.json").read_text())
    for a, b in zip(json.loads(path.read_text()), rec):
        n_a, n_b = a["blocks"] * a["reps"], b["blocks"] * b["reps"]
        st.fer("parity fixed noise", f"mode 3 {a['snr_db']} dB",
               round(a["fer"] * n_a), n_a, (round(b["fer"] * n_b), n_b))
    path = tmp / "parity" / "spread.json"
    st.run("parity spread", lambda: parity_spread.main(
        ["--reps", "3", "--out", str(path)]),
        none_of=("mc_decoder", "llr_decoder", "qc_decoder"))
    rec = json.loads((ROOT / "parity_runs" / "spread.json").read_text())
    res = json.loads(path.read_text())
    for tag, rows in rec.items():
        for a, b in zip(res[tag], rows):
            n_a, n_b = a["n_blocks"] * a["reps"], b["n_blocks"] * b["reps"]
            st.fer("parity spread", f"{tag} {a['snr_db']} dB mean FER",
                   round(a["fer_mean"] * n_a), n_a,
                   (round(b["fer_mean"] * n_b), n_b))


def study_family(st: Studies) -> None:
    """``run_code`` on the ten layered family representatives, layered and
    flooding, against ``family_tpu/RESULTS.md`` (256 frames each)."""
    from ldpc_tpu_torch.scripts import family_validation

    text = FAMILY_REC.read_text()
    ref = {"flooding": md_table(text, "code | n | k"),
           "layered": md_table(text, "code | n | Z")}

    def run_all():
        return [family_validation.run_code(name, schedule)
                for name in family_validation.LAYERED_TARGETS
                for schedule in ("layered", "flooding")]

    rows = st.run("family validation", run_all, needs=("mc_decoder",),
                  none_of=("qc_decoder",))
    for r in rows:
        cells = ref[r["schedule"]][r["name"]]
        ok_ref, blocks_ref = (int(v) for v in cells[-3].split("/"))
        if not r["kernel"].startswith("cuda+fused"):
            fail(f"{r['name']} {r['schedule']} ran {r['kernel']}")
        st.fer("family validation", f"{r['name']} {r['schedule']} "
               f"({r['kernel']}, {r['smem_kb']} KB)", r["blocks"] - r["ok"],
               r["blocks"], (blocks_ref - ok_ref, blocks_ref))


def study_perf_matrix(st: Studies, peak: float) -> None:
    """One cell of the perf matrix (wimax 576 spa/layered-12 at the record's
    Eb/N0, 3 windows of 16 batches) and its ``row_ceiling``."""
    from types import SimpleNamespace

    from ldpc_tpu_torch.scripts import perf_matrix
    from ldpc_tpu_torch.sim.runner import load_code

    rec = json.loads(PERF_REC.read_text())
    rrow = rec["rows"][0]
    name = rrow["code"]
    code = load_code(f"builtin:{name}")
    args = SimpleNamespace(batch=BATCH, n_batches=16, n_windows=3)

    def cell():
        ex = perf_matrix.make_executor(code, *perf_matrix.CONFIGS[0][1:],
                                       BATCH)
        row = perf_matrix.measure_cell(ex, code, rrow["snr_db"], args)
        return row, perf_matrix.row_ceiling(code, ex.opts, rrow["snr_db"],
                                            ex.kernel_used, peak=peak)

    row, ceil = st.run("perf matrix cell", cell, needs=("mc_decoder",),
                       none_of=("qc_decoder",))
    st.equal("perf matrix", "row keys", sorted(
        {"code", "n", "k", "rate", "snr_db", "config", *row}), sorted(rrow))
    frames = args.n_windows * args.n_batches * BATCH
    rframes = rec["n_windows"] * rrow["n_batches"] * rec["batch"]
    st.fer("perf matrix", f"{name} {perf_matrix.CONFIGS[0][0]} "
           f"{rrow['snr_db']} dB", round(row["fer"] * frames), frames,
           (round(rrow["fer"] * rframes), rframes))
    pct = 100 * row["info_bits_per_s"] / ceil["ceiling_info_bits_per_s"]
    log(f"  perf matrix cell ({st.smi}): {row['info_bits_per_s']:.6g} info "
        f"bits/s [{row['info_bits_per_s_mid_lo']:.4g}-"
        f"{row['info_bits_per_s_mid_hi']:.4g}], kernel {row['kernel']}; "
        f"ceiling {ceil['ceiling_info_bits_per_s']:.6g} "
        f"({'two-phase' if ceil['two_phase'] else 'single pass'}, mean "
        f"block trips {ceil['mean_tile_iters']:.4f}): {pct:.2f}%")
    if not 0 < pct < 100:
        fail(f"the perf matrix cell sits at {pct:.2f}% of its ceiling")


def phase_studies(smi: str, peak: float) -> dict:
    """Phase 14: every ported study of ``ldpc_tpu_torch/scripts`` on the
    card at reduced counts, into a temporary directory; returns the
    launches of K1 / K2 / K3 over the phase."""
    import contextlib
    import tempfile

    st = Studies(smi)
    # the studies read their committed inputs relative to the checkout
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(ROOT):
        tmp = Path(tmp)
        study_error_floor(st, tmp)
        study_witness(st, tmp)
        study_importance(st, tmp)
        study_precision(st, tmp)
        study_burst(st, tmp)
        study_learned(st, tmp)
        study_parity(st, tmp)
        study_family(st)
        study_perf_matrix(st, peak)
    log(f"studies on the card ({smi}): study | the card | the TPU record | "
        "verdict")
    for row in st.rows:
        log("  " + " | ".join(row))
    return st.launches


# ------------------------------------------------ the throughput studies ----

ATLAS_REC = ROOT / "examples" / "family_atlas" / "atlas.csv"
ATLAS_BLOCKS = 2048  # frames a point of the atlas's reduced run
STUDY_BATCHES = 16  # batches a window of the levers, variants and envelope


def counts(c: dict) -> tuple[int, int, tuple[int, int]]:
    """A study's comparison (``scripts.study.five_se``) as the arguments of
    :meth:`Studies.fer`."""
    return c["errors"], c["frames"], (c["record_errors"], c["record_frames"])


def throughput_atlas(st: Studies) -> None:
    """The atlas's ``code_rows`` on the record's first code of each family,
    ``ATLAS_BLOCKS`` frames a point, each point against ``atlas.csv``."""
    import csv

    from ldpc_tpu_torch.scripts import family_atlas

    first = {}
    with open(ATLAS_REC, newline="") as f:
        for r in csv.DictReader(f):
            first.setdefault(r["family"], r["code"])
    rows = st.run("family atlas", lambda: [
        r for name in first.values()
        for r in family_atlas.code_rows(name, ATLAS_BLOCKS, 12)],
        needs=("mc_decoder",), none_of=("qc_decoder",))
    held = family_atlas.atlas_vs_record(rows, str(ATLAS_REC))
    if len(held) != 6 * len(first):
        fail(f"the atlas compared {len(held)} of {6 * len(first)} points")
    for c in held:
        st.fer("family atlas", f"{c['code']} {c['snr_db']} dB", *counts(c))


def throughput_big_code(st: Studies, tmp: Path) -> None:
    """Both generated ALISTs byte-equal to the committed ones; the big-code
    study at n=4608 with 16-batch windows and curve points cut to 65,536
    frames, through K1 and through the S-random chain (K3), against
    ``examples/big_code``. n=9216's full run is a study of its own: its
    load alone takes longer than this phase's budget."""
    import hashlib

    from ldpc_tpu_torch.models.generate import wimax_like, write_alist
    from ldpc_tpu_torch.scripts import big_code_study

    def digest(path):
        return hashlib.sha256(path.read_bytes()).hexdigest()

    for Z in (192, 384):
        path = tmp / f"wimax_like_n{24 * Z}_z{Z}.alist.txt"
        write_alist(wimax_like(Z, seed=5), str(path))
        st.equal("big code", f"{path.name} (sha256 of its bytes)",
                 digest(path), digest(ROOT / "examples" / "big_code"
                                      / path.name))
    out = tmp / "big_code"
    rc = st.run("big code", lambda: big_code_study.main(
        ["--zs", "192", "--n-windows", "1", "--n-batches", str(STUDY_BATCHES),
         "--max-blocks", "65536", "--out", str(out)]),
        needs=("mc_decoder", "qc_decoder"))
    res = json.loads((out / "results.json").read_text())
    for name, e in res["codes"].items():
        plan = "; ".join(f"{k} {v['bytes']} B {v['blocks_per_sm']}/SM"
                         for k, v in e["smem_plan"].items())
        log(f"  big code {name} ({st.smi}): load {e['load_rref_G_validate_s']:.2f}"
            f" s; smem {plan}; perf {e['perf']['info_bits_per_s']:.6g} info "
            f"bits/s ({e['perf']['kernel']}), ceiling "
            f"{e.get('ceiling_info_bits_per_s', 0):.6g}")
        if not all(v["fits"] for v in e["smem_plan"].values()):
            fail(f"{name}: a block does not fit: {e['smem_plan']}")
        st.fer("big code", f"{name} perf {e['perf']['snr_db']} dB",
               *counts(e["perf"]["vs_record"]))
        for il in ("none", "srandom"):
            for c in e[f"curve_{il}"]["vs_record"]:
                st.fer("big code", f"{name} {il} {c['snr_db']:.1f} dB",
                       *counts(c))
    if rc != 0:
        fail(f"the big-code study returned {rc}")


def throughput_levers(st: Studies, tmp: Path) -> None:
    """The four levers and the six variants, one window of
    ``STUDY_BATCHES`` batches each, against their records."""
    from ldpc_tpu_torch.scripts import mfu_levers, variant_perf

    b = str(STUDY_BATCHES)
    out = tmp / "levers"
    rc = st.run("MFU levers", lambda: mfu_levers.main(
        ["--n-batches", b, "--n-windows", "1", "--winner-batches", b,
         "--out", str(out)]), needs=("mc_decoder",), none_of=("qc_decoder",))
    for row in json.loads((out / "results.json").read_text())["rows"]:
        st.fer("MFU levers", f"{row['lever']} ({row['kernel']})",
               *counts(row["vs_record"]))
    if rc != 0:
        fail(f"the levers returned {rc}")
    out = tmp / "variants"
    rc = st.run("decoder variants", lambda: variant_perf.main(
        ["--n-batches", b, "--n-windows", "1", "--out", str(out)]),
        needs=("mc_decoder",), none_of=("qc_decoder",))
    for row in json.loads((out / "results.json").read_text())["rows"]:
        if "error" in row:
            fail(f"decoder variant {row['variant']}: {row['error']}")
        st.fer("decoder variants", f"{row['variant']} {row['iterations']} "
               f"it a={row['alpha']} b={row['beta']}",
               *counts(row["vs_record"]))
    if rc != 0:
        fail(f"the variants returned {rc}")


def throughput_two_phase(st: Studies, tmp: Path) -> None:
    """The envelope at 0 and 2 dB (FER equal across off / 6 / auto, K2 in
    the forced split), one paired point of 3 rounds, and the two-phase
    parity check whole (every counter equal, the norm-LLR gate)."""
    from ldpc_tpu_torch.scripts import (
        envelope_paired,
        two_phase_envelope,
        two_phase_parity,
    )

    out = tmp / "envelope"
    rc = st.run("two-phase envelope", lambda: two_phase_envelope.main(
        ["--snrs", "0.0,2.0", "--batches", str(STUDY_BATCHES), "--windows",
         "1", "--out", str(out)]), needs=("mc_decoder", "llr_decoder"),
        none_of=("qc_decoder",))
    for p in json.loads((out / "results.json").read_text())["points"]:
        st.equal("two-phase envelope", f"FER off / 6 / auto at "
                 f"{p['snr_db']} dB", [p[m]["fer"] for m in
                                       two_phase_envelope.MODES],
                 [p["off"]["fer"]] * 3)
        log(f"  envelope {p['snr_db']} dB ({st.smi}): auto/off "
            f"{p['auto_vs_off']:.4f}, forced/off {p['forced_vs_off']:.4f}, "
            f"auto {p['auto']['kernel']}, probe {p['auto_probe']}, implied "
            f"overhead {p['implied_overhead_trips']:.3f} trips")
    if rc != 0:
        fail(f"the envelope returned {rc}")
    rc = st.run("envelope paired", lambda: envelope_paired.main(
        ["--snrs", "3.5", "--rounds", "3", "--batches", str(STUDY_BATCHES),
         "--out", str(out)]), needs=("mc_decoder",), none_of=("qc_decoder",))
    for snr, p in json.loads((out / "paired.json").read_text())["points"] \
            .items():
        log(f"  paired {snr} dB ({st.smi}): t_off / t_auto "
            f"{p['auto_over_off']:.4f} [{p['mid_lo']:.4f}-{p['mid_hi']:.4f}]"
            f", auto {p['auto_kernel']}")
    if rc != 0:
        fail(f"the paired envelope returned {rc}")
    path = tmp / "parity" / "two_phase.json"
    rc = st.run("two-phase parity", lambda: two_phase_parity.main(
        ["--out", str(path)]), needs=("mc_decoder", "llr_decoder"),
        none_of=("qc_decoder",))
    res = json.loads(path.read_text())
    for c in res["cases"]:
        st.equal("two-phase parity", f"{c['code']} {c['schedule']} "
                 f"{c['snr_db']} dB counters off / split / auto",
                 c["match"], True)
    st.equal("two-phase parity", "norm-LLR gate",
             [res["norm_llr_explicit_raises"],
              res["norm_llr_auto_single_phase"]], [True, True])
    if rc != 0:
        fail(f"the two-phase parity check returned {rc}")


def throughput_binder(st: Studies, tmp: Path) -> None:
    """The small-code binder's ladder at 4096 and 65536 frames a batch and
    its isolation at 64 steps (CCSDS n32, 5.65 dB)."""
    from ldpc_tpu_torch.scripts import small_code_binder

    out = tmp / "binder"
    rc = st.run("small-code binder", lambda: small_code_binder.main(
        ["--batches", "4096,65536", "--rounds", "3", "--out", str(out)]),
        needs=("mc_decoder",), none_of=("llr_decoder", "qc_decoder"))
    res = json.loads((out / "binder.json").read_text())
    for batch, p in res["ladder"].items():
        log(f"  binder ladder {batch} ({st.smi}): {p['info_bits_per_s']:.6g} "
            f"info bits/s, {p['per_batch_ms']:.4f} ms a batch ({p['kernel']})")
    iso = res["isolation"]
    if not iso.get("queued_before_spin_ended"):
        fail("the binder's host did not queue every group of steps before "
             f"its spin ended: the device time is not measured ({iso})")
    log(f"  binder isolation ({st.smi}): host {iso['host_us_per_step']:.2f} "
        f"us a step ({iso['step_ops_us_per_batch']:.2f} without K1); "
        f"device {iso['device_us_per_step']:.2f} us a step "
        f"({iso['device_us_per_step_no_kernel']:.2f} without K1, K1 "
        f"{iso['kernel_device_us_per_batch']:.2f}); idle share "
        f"{100 * iso['device_idle_share']:.2f}%, queued before the spin "
        "ended")
    if not 0 < iso["device_us_per_step"] <= iso["host_us_per_step"]:
        fail(f"the binder's device time a step is not within its host time: "
             f"{iso}")
    if rc != 0:
        fail(f"the binder returned {rc}")


def phase_throughput(smi: str) -> dict:
    """Phase 15: the throughput studies of ``ldpc_tpu_torch/scripts`` on
    the card at reduced counts, into a temporary directory; returns the
    launches of K1 / K2 / K3 over the phase."""
    import contextlib
    import tempfile

    st = Studies(smi)
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(ROOT):
        tmp = Path(tmp)
        throughput_atlas(st)
        throughput_big_code(st, tmp)
        throughput_levers(st, tmp)
        throughput_two_phase(st, tmp)
        throughput_binder(st, tmp)
    log(f"throughput studies on the card ({smi}): study | the card | the TPU "
        "record | verdict")
    for row in st.rows:
        log("  " + " | ".join(row))
    return st.launches


# ------------------- the JAX repo's last entry points and its CLI records ----

ENTRY_SNR_DB = 2.5  # Eb/N0 of entry()'s all-zero-codeword batch
EST_BAR = 0.99  # SPA: est equal on >= 99% of frames (tanh / log ulps)
RECORD_TARGET = 50  # --target-errors of the reduced CLI records
RECORD_BLOCKS = 65536  # frames a point at most
VARIANT_END_SNR = 2.5  # the decoder variants at 1.5-2.5 dB


def entry_against_cpu(st: Studies) -> None:
    """16a: ``entry()`` on the card against the same decoder on the CPU, on
    its own N(0, 1) LLRs and on 256 frames of the all-zero codeword at 2.5
    dB (a seeded ``torch.Generator``), where some decode and some do not:
    ``ok`` and ``conv_iter`` equal on every frame, ``est`` on >= 99%."""
    import torch

    from ldpc_tpu_torch.entry import entry

    c_fn, (c_llr,) = entry(device="cpu")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(16)
    sigma2 = 1.0 / (2 * 0.5 * 10 ** (ENTRY_SNR_DB / 10))
    y = 1.0 + math.sqrt(sigma2) * torch.randn(tuple(c_llr.shape), generator=gen)
    zero = (-2.0 * y / sigma2).to(torch.float32)  # log(p1/p0), as entry's
    # the plain flooding decoder: no kernel of K1-K3 launches
    g_fn, (g_llr,) = st.run("entry()", lambda: entry(device="cuda"),
                            none_of=("mc_decoder", "llr_decoder", "qc_decoder"))
    if not g_llr.is_cuda or not torch.equal(g_llr.cpu(), c_llr):
        fail("entry()'s example LLRs differ between the card and the CPU")
    for tag, g_in, c_in, both in (("N(0, 1) example", g_llr, c_llr, False),
                                  (f"all-zero {ENTRY_SNR_DB} dB", zero.cuda(),
                                   zero, True)):
        g_est, g_ok, g_conv = (o.cpu() for o in st.run(
            f"entry() {tag}", lambda: g_fn(g_in),
            none_of=("mc_decoder", "llr_decoder", "qc_decoder")))
        c_est, c_ok, c_conv = c_fn(c_in)
        est_eq = float((g_est == c_est).all(dim=1).to(torch.float64).mean())
        n_ok = int(g_ok.sum())
        st.equal("entry()", f"{tag}: ok ({n_ok} / {len(g_ok)} decode)",
                 g_ok.tolist(), c_ok.tolist(), "the CPU's")
        st.equal("entry()", f"{tag}: conv_iter", g_conv.tolist(),
                 c_conv.tolist(), "the CPU's")
        st.rows.append(("entry()", f"{tag}: est equal on {est_eq:.4f} of "
                        "frames", "the CPU's", "held" if est_eq >= EST_BAR
                        else "NOT held"))
        log(f"  entry() {tag}: est equal on {est_eq:.4f} of frames")
        if est_eq < EST_BAR:
            fail(f"entry() {tag}: est equal on {est_eq:.4f} < {EST_BAR}")
        if both and not 0 < n_ok < len(g_ok):
            fail(f"entry() {tag}: {n_ok} of {len(g_ok)} frames decoded; "
                 "the check needs both outcomes")


def phase_entry_records(smi: str) -> dict:
    """Phase 16: the JAX repo's last entry points (``entry()``, the EXIT
    example) and its CLI-made records on the card, into a temporary
    directory; returns the launches of K1 / K2 / K3 over the phase."""
    import contextlib
    import tempfile

    from ldpc_tpu_torch.scripts import cli_records, exit_charts

    st = Studies(smi)
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(ROOT):
        tmp = Path(tmp)
        entry_against_cpu(st)
        # 16b. the EXIT thresholds
        rc = st.run("exit charts", lambda: exit_charts.main(
            ["--out", str(tmp / "exit")], device="cuda"))
        got = json.loads((tmp / "exit" / "exit_thresholds.json").read_text())
        rec = json.loads(exit_charts.RECORD.read_text())
        for key in (exit_charts.WIMAX_KEY, exit_charts.REGULAR_KEY):
            st.equal("exit charts", f"{key} {got[key]}", got[key], rec[key])
        if rc:
            fail(f"exit_charts returned {rc}")
        # 16c. the rate-1/2 density-evolution threshold
        rate = "1/2"
        record_db = cli_records.de_table(
            cli_records.DE_README.read_text())[rate]
        de = st.run(f"DE threshold {rate}", lambda: cli_records.de_rate(
            rate, record_db, device="cuda"))
        st.rows.append((
            "DE threshold", f"rate {rate}: seeds "
            f"{', '.join(f'{t:.5f}' for t in de['thresholds_db'])} dB, bar "
            f"[{de['bar_db'][0]:.5f}, {de['bar_db'][1]:.5f}]",
            f"{record_db} dB", "held" if de["held"] else "NOT held"))
        log(f"  DE threshold {rate}: {de['thresholds_db']} against "
            f"{record_db} dB ({de['seconds']:.2f} s)")
        if not de["held"]:
            fail(f"the DE threshold at rate {rate} is outside its bar")
        # 16d. the CLI records at reduced counts
        for path, end_snr in (
                (cli_records.WATERFALL / "rate_0.5.json", None),
                *((cli_records.VARIANTS / f"{v}.json", VARIANT_END_SNR)
                  for v in ("sumproduct", "normalized-minsum",
                            "offset-minsum", "minsum"))):
            rows = st.run(f"CLI record {path.name}", lambda: cli_records
                          .hold_record(path, target_errors=RECORD_TARGET,
                                       blocks=RECORD_BLOCKS, end_snr=end_snr,
                                       device="cuda", out_dir=tmp / "records"),
                          needs=("mc_decoder",), none_of=("qc_decoder",))
            for r in rows:
                st.fer(f"CLI record {path.name}", f"{r['snr_db']:g} dB "
                       f"({r['seconds']:.3f} s, {r['layer_order']}, check "
                       f"every {r['check_every']})", r["errors"], r["frames"],
                       (r["record_errors"], r["record_frames"]))
    log(f"the JAX repo's last entry points and CLI records on the card "
        f"({smi}): what | the card | the record | verdict")
    for row in st.rows:
        log("  " + " | ".join(row))
    return st.launches


# ----------------------------------------------------------------- phases ----

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fer-batches", type=int, default=0, metavar="N",
                    help="also run the FER check (phase 6) on N batches of "
                         "4096 frames per layer order and noise source")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t_start = time.perf_counter()

    import numpy as np

    from ldpc_tpu_torch.analysis.roofline import (
        channel_census,
        counter_census,
        decode_work,
        init_census,
        issue_peak_ops_per_s,
        lane_sweeps,
    )
    from ldpc_tpu_torch.models.qc import paired_layer_groups
    from ldpc_tpu_torch.ops import build
    from ldpc_tpu_torch.ops.channel import ChannelParams
    from ldpc_tpu_torch.ops.encode import make_encoder_T
    from ldpc_tpu_torch.ops.mc_kernels import (
        DRAWS_PER_BIT,
        LLR_KERNEL,
        MC_KERNEL,
        LLRDecoder,
        MCDecoder,
    )
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, load_code

    dev = torch.device("cuda", 0)
    log(f"device: {torch.cuda.get_device_name(0)}  torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # ---- 2. build ----
    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    log(f"nvcc: {nvcc.strip().splitlines()[-1]}")
    t0 = time.perf_counter()
    no_offset = start_no_offset_build()  # K1 without the offset, for 13b
    built = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in built.items()))
    ptxas = phase_ptxas()
    peak = issue_peak_ops_per_s()
    log(f"issue peak {peak:.6g} op/s (one f32 instruction per lane per clock; "
        f"{smi})")
    # ---- 3. kernels against their plain versions ----
    code = load_code("builtin:wimax_1152_0.5.alist.txt")
    spec = code.standard_encode_spec
    info_pos = spec.info_pos("orig")
    groups = paired_layer_groups(code.qc)
    n, k = code.n, code.k
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.integers(0, 2, (BATCH, k), dtype=np.uint8)).to(dev)
    wT = make_encoder_T(spec, "orig", dev)(u)
    raw = torch.from_numpy(
        rng.integers(0, 2**32, (DRAWS_PER_BIT[1], n, BATCH), dtype=np.uint32)
        .view(np.int32)).to(dev)
    consts = ChannelParams(mode=1, modulation=1, speed=0.5, snr_db=SNR_DB,
                           noise_model="exact").consts(dev)
    gen = np.random.default_rng(1)
    done0 = torch.from_numpy((gen.random(BATCH) < 0.5).astype(np.float32)).to(dev)
    log("compare (wimax 1152, B=4096, paired, check every 2):")
    errs = {"mc_decoder": 0.0, "llr_decoder": 0.0}
    for variant in ("normalized_minsum", "spa"):
        out = hold_pair(variant, code, groups, variant, wT, consts, done0,
                        iters=ITERS, phase1=PHASE1, check_every=CHECK_EVERY,
                        raw=raw)
        errs = {name: max(errs[name], out[name]) for name in errs}
    del raw
    log(f"compare (other configurations, B={COVER_BATCH}, injected words "
        "and Philox):")
    cover_err = phase_coverage(dev)
    log(f"  largest error over the other configurations: {cover_err:g}")
    log("K1's refill (codewords sharing a warp, one pass):")
    phase_refill(dev, smi, peak)

    # ---- 4. the main path: as 'auto' chooses, then with the split forced ----
    from ldpc_tpu_torch.ops.encode import ENCODE
    from ldpc_tpu_torch.ops.metrics import ADD_COUNTERS, BATCH_COUNTERS
    from ldpc_tpu_torch.utils import timing

    launches = {"mc_decoder": 0, "llr_decoder": 0, "batch_counters": 0,
                "gf2_encode": 0}
    results = {}
    for two_phase in ("auto", str(PHASE1)):
        opts = SimOptions(
            matrix=code.name, blocks=BATCH, iterations=ITERS, ber=True,
            fer=True, fidelity="exact", batch=BATCH, seed=0, speed=0.5,
            schedule="layered", layer_order="paired", check_every=CHECK_EVERY,
            two_phase=two_phase,
        )
        ex = PointExecutor(code, opts)
        ex.run_point(SNR_DB, 2 * BATCH, point_index=99)  # warm: probe + choice
        MC_KERNEL.launches = 0
        LLR_KERNEL.launches = 0
        BATCH_COUNTERS.launches = ADD_COUNTERS.launches = 0
        ENCODE.launches = 0
        t0 = time.perf_counter()
        st = ex.run_point(SNR_DB, MAIN_BATCHES * BATCH)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        run = {"mc_decoder": MC_KERNEL.launches,
               "llr_decoder": LLR_KERNEL.launches,
               "batch_counters": BATCH_COUNTERS.launches,
               "gf2_encode": ENCODE.launches}
        batches = timing.units(timing.RECORDER.spans,
                               "run_point")[-1][0].attrs["batches"]
        fer = st.fer_frames / st.blocks
        sigma = math.sqrt(REF_FER * (1 - REF_FER) / st.blocks)
        log(f"main path two_phase={two_phase}: {st.blocks} frames in "
            f"{elapsed:.4f} s = {st.blocks * k / elapsed:.6g} info bits/s, "
            f"FER {fer:.6f} (ref {REF_FER}, 5 sigma {5 * sigma:.6f}), "
            f"BER {st.error_bits / (st.blocks * k):.3e}, "
            f"kernel {ex.kernel_used}, probe {ex.last_probe}, launches {run}"
            f" (add_counters {ADD_COUNTERS.launches}) over {batches} batches")
        if st.blocks != MAIN_BATCHES * BATCH:
            fail(f"main path counted {st.blocks} frames")
        if (run["batch_counters"], ADD_COUNTERS.launches) != (batches,) * 2:
            fail(f"main path ran {batches} batches but batch_counters / "
                 f"add_counters launched {run['batch_counters']} / "
                 f"{ADD_COUNTERS.launches} times")
        if run["gf2_encode"] != batches:
            fail(f"main path ran {batches} batches but gf2_encode launched "
                 f"{run['gf2_encode']} times")
        if run["mc_decoder"] < 1:
            fail("mc_decoder was not launched on the main path")
        if "+2phase(auto:off)" not in ex.kernel_used and run["llr_decoder"] < 1:
            fail(f"{ex.kernel_used} split batches but never launched llr_decoder")
        if abs(fer - REF_FER) > 5 * sigma:
            fail(f"FER {fer:.6f} is more than 5 sigma from {REF_FER}")
        for name in launches:
            launches[name] += run[name]
        results[two_phase] = st
    if results["auto"] != results[str(PHASE1)]:
        fail(f"the dispatch modes disagree: {results}")
    for name, count in launches.items():
        if count < 1:
            fail(f"{name} was not launched on the main path")
    # ---- 4b. the fused flooding path ----
    phase_fused_flooding(code, dev)

    # ---- 5. the main path's own launches, held and timed ----
    # K1 as 'auto' launches it at this point (12 iterations, single pass),
    # K1 as phase 1 of a split (6 iterations, LLRs emitted), and K2 on that
    # phase 1's compacted output; Philox noise, as on the main path
    key = (0x243F6A88, 0x85A308D3)
    kw = dict(layer_groups=groups, check_every=CHECK_EVERY)
    mc_full = MCDecoder(code.qc, info_pos, ITERS, "spa", **kw)
    mc1 = MCDecoder(code.qc, info_pos, PHASE1, "spa", emit_llr=True, **kw)
    llr_dec = LLRDecoder(code.qc, info_pos, ITERS, "spa", **kw)
    log("compare (the main path's configuration: spa, Philox):")
    o_full, e_full = hold_mc("mc_decoder 12 it", mc_full, None, wT, consts,
                             seeds=key)
    o1, e1 = hold_mc("mc_decoder phase 1", mc1, None, wT, consts, seeds=key)
    order = torch.argsort(o1[1].to(torch.int32), stable=True)
    llr_s = o1[5].index_select(1, order)
    w_s = wT.index_select(1, order)
    done0 = o1[1].index_select(0, order).to(torch.float32)
    o2 = llr_dec(llr_s, w_s, done0)
    sync()
    e2 = compare("llr_decoder phase 2", "spa", o2,
                 llr_dec.plain(llr_s, w_s, done0), "compacted phase 1")
    errs = {"mc_decoder": max(errs["mc_decoder"], e_full, e1),
            "llr_decoder": max(errs["llr_decoder"], e2)}

    # census ops the data needs: each lane's sweeps through its converging
    # check window, the channel fill, counters and init per frame (K1; the
    # emit copies n more), the init and counters per live lane (K2)
    def loop_ops(sw):
        return decode_work(code.qc, "spa", "layered", sweeps=sw,
                           check_every=CHECK_EVERY)

    def mc_bound(o, max_it, emit):
        sw = lane_sweeps(o[1].cpu().numpy(), o[2].cpu().numpy(), max_it)
        ops = loop_ops(sw) + BATCH * (channel_census(code.qc).total()
                                      + (n if emit else 0))
        nbytes = 4 * n * BATCH * (2 if emit else 1) + 32 + 17 * BATCH
        return bound_ms(ops, nbytes, peak) + (int(sw.sum()), ops)

    b_full, by_full, sw_full, ops_full = mc_bound(o_full, ITERS, False)
    b1, by1, sw1, ops1 = mc_bound(o1, PHASE1, True)
    active = done0.cpu().numpy() < 0.5
    sw2 = lane_sweeps(o2[1].cpu().numpy()[active], o2[2].cpu().numpy()[active],
                      ITERS)
    ops2 = loop_ops(sw2) + int(active.sum()) * (
        init_census(code.qc) + counter_census(code.qc)).total()
    bytes2 = 4 * n * 2 * int(active.sum()) + 21 * BATCH  # llr + w of live lanes
    b2, by2 = bound_ms(ops2, bytes2, peak)

    t_full = time_ms(lambda: mc_full(wT, consts, seeds=key), reps=20)
    t_k1 = time_ms(lambda: mc1(wT, consts, seeds=key), reps=20)
    t_k2 = time_ms(lambda: llr_dec(llr_s, w_s, done0), reps=20)
    t_pfull = time_ms(lambda: mc_full.plain(wT, consts, seeds=key), reps=2,
                      warm=1)
    t_p1 = time_ms(lambda: mc1.plain(wT, consts, seeds=key), reps=2, warm=1)
    t_p2 = time_ms(lambda: llr_dec.plain(llr_s, w_s, done0), reps=2, warm=1)
    log(f"timing (spa, B=4096; {smi}): mc_decoder 12 it {t_full:.4f} ms "
        f"(plain {t_pfull:.3f} ms, bound {b_full:.5f} ms by {by_full}, "
        f"{ops_full:.6g} census ops, {sw_full} lane sweeps); mc_decoder phase 1 "
        f"{t_k1:.4f} ms (plain {t_p1:.3f} ms, bound {b1:.5f} ms by {by1}, "
        f"{ops1:.6g} census ops, {sw1} lane sweeps); llr_decoder {t_k2:.4f} ms "
        f"(plain {t_p2:.3f} ms, bound {b2:.5f} ms by {by2}, {ops2:.6g} census "
        f"ops, {int(active.sum())} live lanes, {int(sw2.sum())} lane sweeps)")
    log(f"plans: mc_decoder {plan_tag(mc_full.plan)} "
        f"({mc_full.blocks_per_sm(dev)} blocks/SM), llr_decoder "
        f"{plan_tag(llr_dec.plan)} ({llr_dec.blocks_per_sm(dev)} blocks/SM)")
    # ---- 5b. the decoders' options, held and timed ----
    sl = phase_options_timing(code, dev, wT, consts, peak)
    errs = {name: max(errs[name], sl["errors"][name]) for name in errs}

    # ---- 6-9. K3 and the unfused path ----
    from ldpc_tpu_torch.ops.qc_kernels import QC_KERNEL

    QC_KERNEL.launches = 0
    qc_err, kept = phase_qc_compare(dev)
    k6 = phase_qam_channel(dev, smi)
    k7 = phase_batch_counters(dev, smi)
    k7["launches"] = launches["batch_counters"]  # phase 4's, a batch each
    k8 = phase_encode(dev, smi, peak)
    k8["launches"] = launches["gf2_encode"]  # phase 4's, a batch each
    qc_launches, k6["launches"], qc_batches = phase_unfused(dev)
    qc_times = phase_qc_timing(kept, peak)
    phase_fused_fer()
    phase_unfused_split(smi)
    log(f"qc_decoder launches per batch on the headline run: "
        f"{qc_launches / qc_batches:g}; qam_channel {k6['launches']}")

    # ---- 10. the roofline path (K4, K5) ----
    roof = phase_roofline(dev, smi, peak)
    rate = roof["attainable_census_ops_per_s"]
    log(f"attainable ms at the K5 rate {rate:.6g} census ops/s ({smi}): "
        f"mc_decoder 12 it {1e3 * ops_full / rate:.5f} (bound {b_full:.5f}, "
        f"{t_full:.4f} ms); mc_decoder phase 1 {1e3 * ops1 / rate:.5f} (bound "
        f"{b1:.5f}, {t_k1:.4f} ms); llr_decoder {1e3 * ops2 / rate:.5f} (bound "
        f"{b2:.5f}, {t_k2:.4f} ms); "
        + "; ".join(f"qc_decoder {tag} {1e3 * v[4] / rate:.5f} (bound "
                    f"{v[2]:.5f}, {v[0]:.4f} ms)" for tag, v in qc_times.items()))
    for tag, v in sl["times"].items():
        log(f"attainable ms ({smi}): {tag}: {1e3 * v[4] / rate:.5f} (bound "
            f"{v[2]:.5f} by {v[3]}, {v[0]:.4f} ms, plain {v[1]:.3f} ms, "
            f"{v[5]} blocks/SM)")

    # ---- 12. the reference-fidelity path and the plain decoders ----
    phase_reference(dev, smi)

    # ---- 13. the parallel sweep, meshes and the analyses ----
    t13 = time.perf_counter()
    k3p = phase_k3_points(dev, smi, peak, rate)
    errs["mc_decoder"] = max(errs["mc_decoder"], phase_k1_offset(
        dev, smi, code, wT, consts, no_offset, peak, rate))
    phase_parallel_sweep(smi)
    phase_two_ranks(smi)
    phase_failure_profile(smi)
    phase_importance(smi)
    phase_learned(smi)
    log(f"phase 13: {time.perf_counter() - t13:.1f} s ({smi})")

    # ---- 14. the repo-level studies ----
    t14 = time.perf_counter()
    study_launches = phase_studies(smi, peak)
    log(f"phase 14: {time.perf_counter() - t14:.1f} s ({smi}), launches "
        f"{study_launches}")

    # ---- 15. the throughput studies ----
    t15 = time.perf_counter()
    tp_launches = phase_throughput(smi)
    log(f"phase 15: {time.perf_counter() - t15:.1f} s ({smi}), launches "
        f"{tp_launches}")

    # ---- 16. the JAX repo's last entry points and its CLI records ----
    t16 = time.perf_counter()
    rec_launches = phase_entry_records(smi)
    log(f"phase 16: {time.perf_counter() - t16:.1f} s ({smi}), launches "
        f"{rec_launches}")

    if args.fer_batches:
        phase_fer(args.fer_batches)

    kernels = [
        {"name": "mc_decoder", "route": "cuda", "source": CSRC + "mc_decoder.cu",
         "replaces": "ldpc_tpu/ops/mc_pallas.py:378",
         "launches": launches["mc_decoder"], "max_abs_err": errs["mc_decoder"],
         "ms": t_full, "plain_ms": t_pfull, "bound_ms": b_full,
         "bound_by": by_full, "library_ms": None},
        {"name": "llr_decoder", "route": "cuda", "source": CSRC + "llr_decoder.cu",
         "replaces": "ldpc_tpu/ops/mc_pallas.py:603",
         "launches": launches["llr_decoder"], "max_abs_err": errs["llr_decoder"],
         "ms": t_k2, "plain_ms": t_p2, "bound_ms": b2, "bound_by": by2,
         "library_ms": None},
        {"name": "qc_decoder", "route": "cuda", "source": CSRC + "qc_decoder.cu",
         "replaces": "ldpc_tpu/ops/spa_pallas.py:710",
         "launches": qc_launches,
         "max_abs_err": max(qc_err, sl["errors"]["qc_decoder"], k3p["err"]),
         "ms": qc_times["layered spa-12 serial (16-QAM)"][0],
         "plain_ms": qc_times["layered spa-12 serial (16-QAM)"][1],
         "bound_ms": qc_times["layered spa-12 serial (16-QAM)"][2],
         "bound_by": qc_times["layered spa-12 serial (16-QAM)"][3],
         "library_ms": None},
        k6,
        k7,
        k8,
        *roof["kernels"],
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
