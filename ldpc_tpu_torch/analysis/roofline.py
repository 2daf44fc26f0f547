"""Speed-of-light accounting for the port's fused Monte-Carlo decode kernel.

Counterpart of ``ldpc_tpu/analysis/roofline.py``. Four parts:

* :func:`decode_census` / :func:`channel_census` / :func:`counter_census` /
  :func:`init_census` (``roofline.py:51-293``, copied): the element-ops the
  ALGORITHM runs per frame (one codeword), bucketed into measurable classes
  (fma-class cheap ops, rolls along Z, compare+selects, and the
  transcendentals tanh, log, div, sqrt, cos/sin and PRNG words). They count
  the algorithm, not one implementation's layout, so they give the same
  numbers whatever decodes, and the tests hold them equal to the JAX
  package's. The JAX census's ``sublane_groups`` argument is dropped: it
  prices a TPU register layout (G codewords stacked on the sublanes) that
  the port does not have; its G=1 counts are the ones copied.
* :func:`issue_peak_ops_per_s` and :data:`HBM_BYTES_PER_S`: the card's
  ceilings, replacing ``vpu_peak_ops_per_s`` (``:578-592``) and the TPU v5e's
  819 GB/s (``:650``). The issue peak is one f32 instruction per lane per
  clock: SMs x 128 f32 lanes x the maximum SM clock (33.45e12 op/s on an
  H100 SXM at 1980 MHz). It is not the data sheet's 67 TFLOP/s, which counts
  an FMA as two flops; the kernels are built with ``-fmad=false`` and hold no
  FMA, and the census counts instructions, not flops.
* :func:`measure_rates` (``measure_vpu_rates``, ``:386-433``) and
  :func:`measure_mix_rate` (``:460-575``): measured rates of the two CUDA
  probes of ``ops/rate_kernels.py`` (K4 ``rate_chain``, K5 ``mix_rate``),
  by the same slope method (two depths, median of reps, launch overhead
  cancels) and the same guard, which raises when the time did not grow
  with depth. Times are CUDA events around each launch.
* :func:`speed_of_light` / :func:`speed_of_light_two_phase` (``:595-744``,
  copied; defaults: the card's issue peak and HBM rate) and
  :func:`measure_tile_trips` (``:747-849``) on the port's ``MCDecoder``.

Report keys renamed from the JAX package's (``scripts/roofline.py``), as
:data:`RENAMED_KEYS` lists them:

========================== ===========================
JAX package                port
========================== ===========================
``vpu_peak_ops_per_s``     ``issue_peak_ops_per_s``
``vpu_measured_floor_gops`` ``measured_floor_gops``
``sustained_vpu_ops_per_s`` ``sustained_issue_ops_per_s``
========================== ===========================

The JAX package's ``bench.py`` key ``pct_of_vpu_ceiling`` is
``pct_of_ceiling`` in the port's bench.
"""

from __future__ import annotations

import subprocess
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch

from ldpc_tpu_torch.models.qc import QCLayout
from ldpc_tpu_torch.ops.channel import ChannelParams
from ldpc_tpu_torch.ops.decode_loop import block_max_trips
from ldpc_tpu_torch.ops.encode import make_encoder_T, random_info_bits
from ldpc_tpu_torch.ops.mc_kernels import MCDecoder
from ldpc_tpu_torch.ops.rate_kernels import (
    OPS_PER_BODY,
    UNROLL,
    MixChain,
    RateChain,
    build_mix_libraries,
)
from ldpc_tpu_torch.ops.spa import exclusive_combine
from ldpc_tpu_torch.sim.runner import (
    derive_key,
    resolve_layer_groups,
    resolve_two_phase,
    two_phase_trip_model,
)
from ldpc_tpu_torch.utils.device import resolve_device

# measurable op classes; "fma" covers every 1-op vector instruction
# (add/sub/mul/min/max/and/xor/shift/cast/compare each retire at the same
# per-lane rate -- the fma chain measures that rate)
CLASSES = ("fma", "roll", "where", "tanh", "log", "div", "sqrt", "cossin",
           "prng")

RENAMED_KEYS = {
    "vpu_peak_ops_per_s": "issue_peak_ops_per_s",
    "vpu_measured_floor_gops": "measured_floor_gops",
    "sustained_vpu_ops_per_s": "sustained_issue_ops_per_s",
}

# H100 SXM: 80 GB of HBM3 at 3.35 TB/s (data sheet)
HBM_BYTES_PER_S = 3.35e12

# f32 lanes per SM, by card name: one f32 instruction per lane per clock
F32_LANES_PER_SM = {"H100": 128}

TRIP_KEY = 100  # key of the trip probe's batches (derive_key(TRIP_KEY, i))

# the slope method: the deeper of its two depths is sized so that one launch
# takes about TARGET_S; each depth's time is the median of REPS launches
TARGET_S = 0.03
REPS = 5


@dataclass
class OpCount:
    """Element-op counts per frame (one codeword): a [Z, TB] vector op
    contributes Z element-ops per frame, a [1, TB] op contributes 1."""

    counts: dict[str, float] = field(default_factory=lambda: dict.fromkeys(CLASSES, 0.0))

    def add(self, cls: str, n: float) -> None:
        self.counts[cls] += n

    def __add__(self, other: "OpCount") -> "OpCount":
        out = OpCount()
        for c in CLASSES:
            out.counts[c] = self.counts[c] + other.counts[c]
        return out

    def scaled(self, s: float) -> "OpCount":
        out = OpCount()
        for c in CLASSES:
            out.counts[c] = self.counts[c] * s
        return out

    def total(self) -> float:
        return sum(self.counts.values())


def _count_exclusive(d: int) -> int:
    """Exact number of binary combines exclusive_combine(d values) performs
    (None is a symbolic identity, not an op) -- counted by running it."""
    ops = 0

    def op(a, b):
        nonlocal ops
        ops += 1
        return a

    exclusive_combine(list(range(d)), op)
    return ops


def _check_update_census(c: OpCount, Z: int, d: int, variant: str) -> None:
    """Ops of one check-node update over d messages of [Z, TB]
    (spa_pallas.make_check_update, mirrored op for op)."""
    if variant == "spa":
        # per msg: mul 0.5, clip (min+max), tanh, clip (min+max)
        c.add("fma", d * Z * 5)
        c.add("tanh", d * Z)
        # exclusive product combine
        c.add("fma", _count_exclusive(d) * Z)
        # atanh2 per slot: clip (2), 1+p, 1-p, div, log
        c.add("fma", d * Z * 4)
        c.add("div", d * Z)
        c.add("log", d * Z)
        return
    # min-sum family: sign (cmp+select), abs
    c.add("where", d * Z)
    c.add("fma", d * Z)
    # exclusive sign product + exclusive min
    c.add("fma", 2 * _count_exclusive(d) * Z)
    if variant == "normalized_minsum":
        c.add("fma", d * Z)  # alpha * mag (scheduled alpha: same 1 mul)
    elif variant == "offset_minsum":
        c.add("fma", d * Z * 2)  # mag - beta, max(0)
    c.add("fma", d * Z)  # sign * mag


def decode_census(
    qc: QCLayout,
    variant: str = "spa",
    schedule: str = "layered",
    track_norm: bool = False,
    scheduled_alpha: bool = False,
    check_every: int = 1,
) -> OpCount:
    """Element-ops of ONE decode iteration (sweep) per frame (codeword).

    Mirrors the decode loop (layered or flooding sweep, syndrome,
    normalized-LLR bookkeeping) op for op; rolls with shift % Z == 0 are
    free and not counted. ``check_every=N`` amortizes the syndrome and
    convergence-bookkeeping ops over N sweeps. ``scheduled_alpha`` is
    accepted for the JAX signature and changes nothing (a scheduled alpha
    costs the same one multiply)."""
    Z, nb, mb = qc.Z, qc.nb, qc.mb
    row_slots = qc.row_slots()
    c = OpCount()

    def roll(s, into=None):
        if s % Z:
            (into if into is not None else c).add("roll", Z)

    for bi in range(mb):
        slots = row_slots[bi]
        d = len(slots)
        # msgs = roll(L) - E
        for _, s in slots:
            roll(s)
        c.add("fma", d * Z)
        _check_update_census(c, Z, d, variant)
        if schedule == "layered":
            ncols = len({bj for bj, _ in slots})
            if ncols < d:
                # deltas: per slot sub + roll; per distinct col where-add
                c.add("fma", d * Z)
                for _, s in slots:
                    roll(-s)
                c.add("fma", ncols * Z)  # L + d
                c.add("where", ncols * Z)
            else:
                # l_new = roll(msg + e_new); L = where(active, l_new, L)
                c.add("fma", d * Z)
                for _, s in slots:
                    roll(-s)
                c.add("where", d * Z)
            c.add("where", d * Z)  # E freeze-select
        else:
            c.add("where", d * Z)  # E freeze-select

    if schedule == "flooding":
        # posterior: acc = llr + sum over column slots of roll(E)
        col_slots = qc.col_slots()
        for bj in range(nb):
            for _, _, s in col_slots[bj]:
                roll(-s)
                c.add("fma", Z)

    # syndrome: per edge roll + cmp + xor; per row an any-reduce over Z --
    # executed once per check_every sweeps (amortized below)
    syn = OpCount()
    for bi in range(mb):
        for _, s in row_slots[bi]:
            roll(s, into=syn)
        d = len(row_slots[bi])
        syn.add("fma", 2 * d * Z)  # cmp(<0) + xor fold
        syn.add("fma", Z)  # any over the rows of the block
        syn.add("fma", 1)  # any_unsat |=
    for cls, cnt in syn.counts.items():
        c.add(cls, cnt / check_every)
    if track_norm:
        # per column: abs, cmp, prior*L, cmp, and, cast, *mask, sum(Z), add
        c.add("fma", nb * (7 * Z + Z))
        c.add("fma", nb)  # flips accumulate [1, TB]
        c.add("where", 1)  # norm select
    # convergence bookkeeping, once per check: [1, TB] masks
    c.add("where", 2 / check_every)
    return c


def channel_census(qc: QCLayout, mode: int = 1) -> OpCount:
    """Element-ops of the in-kernel channel fill per frame (noise words,
    Box-Muller with the 48-bit radial uniform, channel LLRs), plus the
    counter tail and the decode-loop init, mirrored op for op."""
    Z, nb = qc.Z, qc.nb
    c = OpCount()
    npairs = (nb + 1) // 2  # adjacent base columns share one draw pair

    def normal_pair():
        # 3 PRNG planes of [Z, TB]
        c.add("prng", 3 * Z)
        # uniform48: 2x(shift+cast), mul, fma, min = 7; uniform24: 4
        c.add("fma", (7 + 4) * Z)
        # r = sqrt(-2 log u1): log, mul, sqrt; ang = 2pi*u2: mul
        c.add("log", Z)
        c.add("sqrt", Z)
        c.add("fma", 2 * Z)
        # cos + sin branches, 2 muls
        c.add("cossin", 2 * Z)
        c.add("fma", 2 * Z)

    for _ in range(npairs):
        normal_pair()
        if mode != 1:
            normal_pair()
    for _ in range(nb):
        # bpsk: 2x-1 (amp=1 fused): 2 ops; llr scale + noise fma + negate
        c.add("fma", 5 * Z)
        if mode == 2:
            c.add("prng", Z)  # jam uniform plane
            c.add("fma", (4 + 1) * Z)  # uniform24 + cmp
            c.add("fma", 3 * Z)  # both branch LLRs: n2 add, 2nd scale, (n1 counted)
            c.add("where", Z)
        elif mode == 3:
            c.add("fma", 5 * Z)  # mix: add n2, 2 muls p/(1-p), add, *l_c3
    return c + counter_census(qc) + init_census(qc)


def counter_census(qc: QCLayout) -> OpCount:
    """Element-ops of the info-bit error count per frame (est vs sent bits
    over every base column)."""
    c = OpCount()
    # est cmp, neq cmp, cast, *mask, sum(Z), add -- per column
    c.add("fma", qc.nb * (4 * qc.Z + qc.Z))
    c.add("fma", qc.nb)
    return c


def init_census(qc: QCLayout) -> OpCount:
    """Element-ops of the decode-loop init per frame: L copy per column,
    E zero per slot."""
    c = OpCount()
    c.add("fma", qc.n)
    c.add("fma", sum(len(r) for r in qc.row_slots()) * qc.Z)
    return c


# ---------------------------------------------------------------------------
# the card's ceilings and measured rates
# ---------------------------------------------------------------------------

def _cuda_device(device) -> torch.device:
    """The card to measure: ``None`` means CUDA (raising without it); the
    CPU has no device metric to give."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the roofline probes time the card; {dev} has none")
    return dev


def issue_peak_ops_per_s(device_name: str | None = None,
                         sm_count: int | None = None,
                         max_sm_clock_mhz: float | None = None,
                         device=None) -> float:
    """Issue ceiling of the card: one f32 instruction per lane per clock,
    SM count x f32 lanes per SM x the maximum SM clock.

    With no arguments, the card's name and SM count come from PyTorch and
    its maximum SM clock from ``nvidia-smi --query-gpu=clocks.max.sm``
    (1980 MHz on the H100 SXM: 132 x 128 x 1.98e9 = 33.45e12 op/s). A card
    without a lane model here raises, as the JAX package's peak does."""
    if device_name is None or sm_count is None or max_sm_clock_mhz is None:
        dev = _cuda_device(device)
        props = torch.cuda.get_device_properties(dev)
        device_name = device_name or props.name
        sm_count = sm_count or props.multi_processor_count
        if max_sm_clock_mhz is None:
            ident = (f"GPU-{props.uuid}" if getattr(props, "uuid", None)
                     else str(dev.index))
            out = subprocess.run(
                ["nvidia-smi", f"--id={ident}", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=60, check=True)
            max_sm_clock_mhz = float(out.stdout.split()[0])
    lanes = next((v for k, v in F32_LANES_PER_SM.items() if k in device_name),
                 None)
    if lanes is None:
        raise ValueError(
            f"no issue-peak model for {device_name!r}: add its f32 lanes per "
            "SM to F32_LANES_PER_SM"
        )
    return float(sm_count) * lanes * float(max_sm_clock_mhz) * 1e6


def full_occupancy_launch(device) -> tuple[int, int]:
    """(blocks, threads): 256-thread blocks, as many as the card's SMs hold
    threads at once."""
    props = torch.cuda.get_device_properties(device)
    per_sm = props.max_threads_per_multi_processor // 256
    return props.multi_processor_count * per_sm, 256


def _time_median(fn, reps: int) -> float:
    """Median seconds of one ``fn()`` on the card (CUDA events, after a
    warm call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / 1e3)
    times.sort()
    return times[len(times) // 2]


def _slope(name: str, time_at, unit: int, verbose: bool):
    """(d_lo, d_hi, t_lo, t_hi) of the slope method: a probe at 64 units
    picks d_hi so that t_hi is near :data:`TARGET_S` (the probe's launch
    overhead makes it err low) and d_lo = d_hi / 8. Raises when the time did
    not grow with depth."""
    d0 = 64 * unit
    per = time_at(d0) / d0
    d_hi = int(min(max(TARGET_S / max(per, 1e-15), 8 * d0), 2**26))
    d_hi -= d_hi % (8 * unit)
    d_lo = d_hi // 8
    t_lo, t_hi = time_at(d_lo), time_at(d_hi)
    if verbose:
        print(f"#   [{name}] depths {d_lo}/{d_hi}: t_lo={t_lo:.6f}s "
              f"t_hi={t_hi:.6f}s", flush=True)
    if t_hi - t_lo <= 0.05 * t_hi:
        raise RuntimeError(
            f"roofline probe '{name}' did not scale with depth "
            f"(t_lo={t_lo:.6f}s, t_hi={t_hi:.6f}s): launch noise dominates "
            "-- raise the depths"
        )
    return d_lo, d_hi, t_lo, t_hi


def measure_rates(*, device=None, verbose: bool = False) -> dict[str, float]:
    """Measured census ops/s per class on the card (K4 ``rate_chain``).

    Each class runs a dependent chain of its body on a 32-row tile, one value
    per thread, on the card full of 256-thread blocks. Rate = extra bodies /
    extra time between two depths. A body retires :data:`OPS_PER_BODY` census ops as the card runs it (fma: FMUL +
    FADD, since ``-fmad=false``); the class op's time is the body's less its
    fma-class stabilizers priced at the measured fma rate, floored at a
    quarter of the body."""
    dev = _cuda_device(device)
    blocks, threads = full_occupancy_launch(dev)
    x = torch.full((32, blocks * threads // 32), 0.33, dtype=torch.float32,
                   device=dev)
    elems = x.numel()

    def t_body(op):
        def time_at(d):
            return _time_median(lambda: RateChain(op, d)(x), REPS)

        d_lo, d_hi, t_lo, t_hi = _slope(op, time_at, UNROLL, verbose)
        return (t_hi - t_lo) / ((d_hi - d_lo) * elems)

    t_op = t_body("fma") / OPS_PER_BODY["fma"]
    rates = {"fma": 1.0 / t_op}
    for cls in CLASSES[1:]:
        t = t_body(cls)
        rates[cls] = 1.0 / max(t - (OPS_PER_BODY[cls] - 1) * t_op, 0.25 * t)
    return rates


def _mix_schedule(mix: dict[str, float], length: int = 64) -> list[str]:
    """Integerize a census op histogram into a round-robin op schedule of
    ~``length`` ops preserving the class ratios (largest-remainder)."""
    total = sum(v for v in mix.values() if v > 0)
    if total <= 0:
        raise ValueError("empty op mix")
    want = {c: length * v / total for c, v in mix.items() if v > 0}
    counts = {c: int(w) for c, w in want.items()}
    rem = sorted(want, key=lambda c: want[c] - counts[c], reverse=True)
    for c in rem[: length - sum(counts.values())]:
        counts[c] += 1
    counts = {c: n for c, n in counts.items() if n > 0}
    # interleave classes so no class's ops cluster (better scheduling
    # realism AND keeps per-stream chains mixed like the real kernel)
    sched: list[str] = []
    pools = {c: n for c, n in counts.items()}
    while any(pools.values()):
        for c in sorted(pools, key=lambda c: -pools[c]):
            if pools[c] > 0:
                sched.append(c)
                pools[c] -= 1
    return sched


def measure_mix_rate(mix: dict[str, float], *,
                     launch: tuple[int, int] | None = None, streams: int = 8,
                     device=None, verbose: bool = False) -> dict:
    """ATTAINABLE sustained census ops/s on the op mix ``mix`` (K5
    ``mix_rate``): the :func:`_mix_schedule` sequence over ``streams``
    independent register chains per thread, so the scheduler may interleave
    them, at the ``launch`` shape (blocks, threads) -- by default the card
    full of 256-thread blocks; pass K1's shape to see what its launch costs.

    Each schedule slot credits one census op while its body retires
    :data:`OPS_PER_BODY` of them, so the rate is conservative by
    ``stabilizer_frac``. Returns ``{"census_ops_per_s",
    "retired_ops_per_s", "schedule_counts", "stabilizer_frac", "streams",
    "t_lo_s", "t_hi_s", "depths", "launch", "blocks_per_sm"}``."""
    dev = _cuda_device(device)
    sched = _mix_schedule(mix)
    L = len(sched)
    retired = sum(OPS_PER_BODY[c] for c in sched)
    blocks, threads = launch or full_occupancy_launch(dev)
    x = torch.full((32, blocks * threads // 32), 0.33, dtype=torch.float32,
                   device=dev)
    elems = x.numel()

    def time_at(d):
        return _time_median(lambda: MixChain(sched, streams, d, threads)(x),
                            REPS)

    d_lo, d_hi, t_lo, t_hi = _slope(f"mix s={streams} {blocks}x{threads}",
                                    time_at, 2, verbose)
    census_per_s = (d_hi - d_lo) * L * elems / (t_hi - t_lo)
    return {
        "census_ops_per_s": census_per_s,
        "retired_ops_per_s": census_per_s * retired / L,
        "schedule_counts": dict(Counter(sched)),
        "stabilizer_frac": retired / L - 1.0,
        "streams": streams,
        "t_lo_s": t_lo,
        "t_hi_s": t_hi,
        "depths": [d_lo, d_hi],
        "launch": [blocks, threads],
        "blocks_per_sm": MixChain(sched, streams, 2, threads).blocks_per_sm(dev),
    }


def build_mix_ladder(mix: dict[str, float], streams):
    """Build the K5 libraries of every stream count at once (one ``nvcc``
    each, started together); returns ``{label: {"seconds", "log"}}``."""
    return build_mix_libraries(_mix_schedule(mix), streams)


# ---------------------------------------------------------------------------
# speed of light
# ---------------------------------------------------------------------------

def speed_of_light(
    qc: QCLayout,
    rates: dict[str, float] | None = None,
    *,
    k: int,
    variant: str = "spa",
    schedule: str = "layered",
    mode: int = 1,
    track_norm: bool = False,
    mean_tile_iters: float = 1.0,
    peak_ops_per_s: float | None = None,
    check_every: int = 1,
) -> dict:
    """Lower-bound time per frame and ceiling info bits/s for the fused
    kernel at a measured mean per-block iteration count.

    The primary bound divides the total census element-ops by the card's
    issue peak (``peak_ops_per_s``, default :func:`issue_peak_ops_per_s`)
    -- every op one instruction, perfect issue. When measured per-class
    ``rates`` are also given, a secondary ``floor_*`` bound prices each
    class at its measured dependent-chain rate."""
    per_iter = decode_census(qc, variant, schedule, track_norm,
                             check_every=check_every)
    fixed = channel_census(qc, mode)
    frame = fixed + per_iter.scaled(mean_tile_iters)

    peak = peak_ops_per_s or issue_peak_ops_per_s()
    t_frame = frame.total() / peak
    out = {
        "per_iter_ops": {c: per_iter.counts[c] for c in CLASSES},
        "fixed_ops": {c: fixed.counts[c] for c in CLASSES},
        "frame_ops_by_class": {c: frame.counts[c] for c in CLASSES},
        "mean_tile_iters": mean_tile_iters,
        "issue_peak_ops_per_s": peak,
        "frame_ops": frame.total(),
        "t_frame_s": t_frame,
        "t_decode_iter_s": per_iter.total() / peak,
        "t_fixed_s": fixed.total() / peak,
        "ceiling_frames_per_s": 1.0 / t_frame,
        "ceiling_info_bits_per_s": k / t_frame,
    }
    if rates is not None:
        t_floor = sum(frame.counts[c] / rates[c] for c in CLASSES)
        out["floor_t_frame_s"] = t_floor
        out["floor_info_bits_per_s"] = k / t_floor
    return out


def speed_of_light_two_phase(
    qc: QCLayout,
    rates: dict[str, float] | None = None,
    *,
    k: int,
    variant: str = "spa",
    schedule: str = "layered",
    mode: int = 1,
    track_norm: bool = False,
    phase1: int | None = None,
    trip_model: dict,
    peak_ops_per_s: float | None = None,
    hbm_bytes_per_s: float = HBM_BYTES_PER_S,
    check_every: int = 1,
) -> dict:
    """Speed-of-light ceiling for the TWO-PHASE fused dispatch
    (``roofline.py:653-744``): every frame runs ~phase1 loop trips, only the
    unconverged fraction re-runs the full budget in the LLR kernel, and the
    split adds device-memory traffic. The ceiling is

        t_frame >= max(ops_2p / issue_peak,  hbm_bytes_2p / hbm_rate)

    with ops_2p = channel fill + init + counters + the n-element LLR emit
    + per_iter x phase1_mean + per_iter x phase2_per_tile
    + (init + counters) x refeed_tile_frac, where ``trip_model`` is
    ``sim.runner.two_phase_trip_model`` measured at the operating point.
    Bytes per frame: (6 + 2 x refeed_tile_frac) x 4n (the phase-1 w read,
    the emit write, the sort's gathers of llr and w, and the phase-2 input
    streams of the tiles that re-enter)."""
    per_iter = decode_census(qc, variant, schedule, track_norm,
                             check_every=check_every)
    fixed = channel_census(qc, mode)
    tails = init_census(qc) + counter_census(qc)
    emit = OpCount()
    emit.add("fma", qc.n)  # the LLR emit, one copy per element
    frame = (
        fixed + emit
        + per_iter.scaled(trip_model["phase1_mean"])
        + per_iter.scaled(trip_model["phase2_per_tile"])
        + tails.scaled(trip_model["refeed_tile_frac"])
    )
    peak = peak_ops_per_s or issue_peak_ops_per_s()
    t_compute = frame.total() / peak
    hbm_bytes = (6 + 2 * trip_model["refeed_tile_frac"]) * 4 * qc.n
    t_mem = hbm_bytes / hbm_bytes_per_s
    t_frame = max(t_compute, t_mem)
    out = {
        "phase1": phase1,
        "trip_model": dict(trip_model),
        "per_iter_ops": {c: per_iter.counts[c] for c in CLASSES},
        "frame_ops_by_class": {c: frame.counts[c] for c in CLASSES},
        "frame_ops": frame.total(),
        "issue_peak_ops_per_s": peak,
        "hbm_bytes_per_frame": hbm_bytes,
        "hbm_bytes_per_s": hbm_bytes_per_s,
        "t_compute_s": t_compute,
        "t_mem_s": t_mem,
        "t_frame_s": t_frame,
        "ceiling_frames_per_s": 1.0 / t_frame,
        "ceiling_info_bits_per_s": k / t_frame,
    }
    if rates is not None:
        t_floor = max(
            sum(frame.counts[c] / rates[c] for c in CLASSES), t_mem
        )
        out["floor_t_frame_s"] = t_floor
        out["floor_info_bits_per_s"] = k / t_floor
    return out


def measure_tile_trips(code, opts, snr_db: float, *, batches: int = 8,
                       device=None):
    """Measured per-block trip statistics at an operating point.

    Runs the single-pass fused kernel (``MCDecoder``, the exact decode-loop
    configuration of ``opts``: variant, schedule, paired layers, syndrome
    cadence) at the full iteration budget on ``batches`` batches and returns
    ``(mean_block_iters, trip_model)``. The kernel iterates each block of
    ``MCDecoder.lanes`` codewords until all of them pass the syndrome check,
    so the work unit is the block: its ``iters`` output is sampled once per
    block (where the kernel refills, ``iters`` are each codeword's own
    trips, and a block's are their largest, ``block_max_trips``). The trip
    model (``sim.runner.two_phase_trip_model`` with
    ``lanes=dec.lanes``, averaged over the batches, plus ``lanes``)
    reconstructs both dispatch modes' block trips from the per-frame
    convergence, so its ``single`` entry cross-checks the readback.

    Batch ``i`` draws its info bits from a ``torch.Generator`` seeded from
    ``derive_key(100, i)`` and its Philox key from ``derive_key`` of that.
    ``device=None`` means the card; the CPU runs the plain version."""
    dev = resolve_device(device)
    opts = opts.resolved()
    qc = code.qc
    schedule = opts.schedule or "flooding"
    spec = code.encode_spec(opts.encoding_method, opts.ru_gap)
    encode_T = make_encoder_T(spec, "orig", dev)
    dec = MCDecoder(
        qc, spec.info_pos("orig"), opts.iterations, opts.decoder_variant,
        mode=opts.mode, modulation=opts.modulation, alpha=opts.minsum_alpha,
        beta=opts.minsum_beta, schedule=schedule,
        layer_groups=resolve_layer_groups(qc, opts, schedule),
        check_every=opts.check_every,
    )
    consts = ChannelParams(
        mode=opts.mode, modulation=opts.modulation, speed=opts.speed,
        snr_db=snr_db, interference_snr_db=opts.interference_snr,
        p=opts.p, noise_model=opts.noise_model,
    ).consts(dev)
    B = opts.auto_batch(code.n)
    # price a hypothetical iterations//2 split (on a check boundary) when the
    # configuration resolves to none, as the JAX function does
    ce = max(1, opts.check_every)
    phase1 = resolve_two_phase(
        opts.two_phase, opts.iterations, opts.check_every
    ) or max(ce, (opts.iterations // 2) // ce * ce)
    block_iters, models = [], []
    for i in range(batches):
        key = derive_key(TRIP_KEY, i)
        gen = torch.Generator(device=dev)
        gen.manual_seed(key >> 1)
        u = random_info_bits(gen, B, code.k)
        s = derive_key(key, 1)
        _, ok, conv, _, iters = dec(encode_T(u), consts,
                                    seeds=(s & 0xFFFFFFFF, s >> 32))
        if dec.refills(B, dev):
            iters = block_max_trips(ok, conv, dec.lanes, opts.iterations)
        block_iters.append(float(iters[::dec.lanes].to(torch.float32).mean()))
        models.append(two_phase_trip_model(
            conv.cpu().numpy(), ok.cpu().numpy(), phase1, opts.iterations,
            lanes=dec.lanes,
        ))
    model = {k2: float(np.mean([m[k2] for m in models])) for k2 in models[0]}
    model["lanes"] = float(dec.lanes)
    return float(np.mean(block_iters)), model


def lane_sweeps(ok: np.ndarray, conv: np.ndarray, max_it: int) -> np.ndarray:
    """Sweeps each lane's data needs: through its converging check window,
    or the whole budget."""
    return np.where(ok, conv.astype(np.int64) + 1, max_it)


def decode_work(qc: QCLayout, variant: str, schedule: str, *,
                sweeps: np.ndarray, check_every: int = 1,
                track_norm: bool = False) -> float:
    """Census element-ops of the decode loop over lanes that run
    ``sweeps`` sweeps each (the data's own need, not the budget)."""
    per = decode_census(qc, variant, schedule, track_norm,
                        check_every=check_every).total()
    return per * float(np.sum(sweeps))
