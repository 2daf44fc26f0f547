"""SNR sweep and Monte-Carlo point executor of the port.

Counterpart of ``ldpc_tpu/sim/runner.py``: ``PointExecutor`` (``:413-1092``),
``run_simulation`` (``:1095-1402``) and ``run_simulation_parallel``
(``:1405-1549``). :func:`choose_route` decides, in one place, which of two
pipelines a configuration's batches take, the unfused path's decoder, the
layer groups, the two-phase split, ``kernel_used`` and every refusal.

The fused path (``:521-872``), for what :func:`choose_route` sends there (a
QC code the K1 kernel takes, no interleaver, BPSK or the QPSK proxy, no
shorten/puncture):

1. random info bits (a ``torch.Generator`` seeded from (seed, point, batch));
2. the systematic encode (ops.encode): on the card one kernel, K8, that
   writes the codewords on the minor axis;
3. the fused Monte-Carlo kernel (ops.mc_kernels.MCDecoder): Philox noise
   keyed from (seed, point, batch), channel LLRs, the decode (phase 1 of a
   two-phase split, emitting its LLRs) and the error counts;
4. with a split, a stable argsort on ``ok`` that compacts the unconverged
   frames to the front lanes, and the LLR kernel (ops.mc_kernels.LLRDecoder)
   re-decoding them from the emitted LLRs with the full budget;
5. the failed-frames BER rule (ops.metrics.failed_frame_errors).

The unfused path (``:891-946``), for every other configuration; the batch's
key splits into three generators (info bits, interleaver, channel):

1. random info bits, the last S zeroed under shorten;
2. the systematic encode into [B, n] (K8 on the card);
3. interleave; the channel (ops.channel); deinterleave: for Gray QAM one
   kernel on the card, K6 (ops.qam_channel), from the same draws;
4. punctured positions become erasures (``llr * mask``), shortened ones
   known zeros (-60);
5. the route's decoder (:meth:`Route.unfused_decoder`): the QC decoder
   (ops.qc_kernels.QCDecoder, the CUDA port of ``spa_pallas.make_qc_decoder``)
   or a plain PyTorch decoder (ops.spa, ops.layered);
6. ``block_stats``, which applies the same BER rule.

Either way a batch's counters are packed (:meth:`PointExecutor.packed`) and
summed on the device (``ops.metrics.add_packed``), one K7 launch each on the
card (``ops.metrics.batch_counters``), and fetched totals become
``PointStats`` (``PointStats.add``), in ``run_point`` and the parallel sweep.

``fused='auto'`` takes the fused path wherever :func:`choose_route` finds it
eligible, on either device, as the JAX package's does on a TPU.

A Python loop over batches takes the place of ``lax.scan``. Counters
accumulate on the device and the host fetches them once per point; under
``target_errors`` it checks the quota on the JAX runner's schedule (groups
of up to 8 batches where its fused path runs, else every batch). Every
decode op is per codeword, so a two-phase split gives the same counters as
a single pass, and a point run in pieces (``start_batch``) gives the same
counters as one run.

Meshes (:mod:`ldpc_tpu_torch.parallel`): on a ``batch`` axis each rank
decodes its rows of every batch, drawing the whole batch's info bits (and,
unfused, its interleaver and channel) and, fused, K1's Philox noise from
its rows' codeword offset, so the summed counters equal an unmeshed run's.
The parallel sweep runs the points of a batch index as one step
(:meth:`PointExecutor.sweep_step`: one K3 launch over the live points'
frames), dealt over an ``snr`` axis.

``--profile DIR`` wraps the sweep in a ``torch.profiler`` trace written to
DIR; the spans of :mod:`ldpc_tpu_torch.utils.timing` are host events of that
trace, and go to ``DIR/spans.json`` as well.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from dataclasses import dataclass
from datetime import datetime
from functools import lru_cache

import numpy as np
import torch

from ldpc_tpu_torch.models import standards
from ldpc_tpu_torch.models.code import LDPCCode
from ldpc_tpu_torch.models.qc import paired_layer_groups
from ldpc_tpu_torch.ops.channel import ChannelParams, make_channel_fn
from ldpc_tpu_torch.ops.decode_loop import VARIANTS
from ldpc_tpu_torch.ops.encode import (
    ENCODE,
    make_encoder,
    make_encoder_T,
    random_info_bits,
)
from ldpc_tpu_torch.ops.interleave import make_interleaver
from ldpc_tpu_torch.ops.layered import make_qc_layered_decoder
from ldpc_tpu_torch.ops.mc_kernels import (
    LLR_KERNEL,
    MC_KERNEL,
    LLRDecoder,
    MCDecoder,
)
from ldpc_tpu_torch.ops.metrics import (
    ADD_COUNTERS,
    BATCH_COUNTERS,
    SLOTS,
    BlockCounters,
    BlockStats,
    add_packed,
    batch_counters,
    block_stats,
    failed_frame_errors,
    unpack_counters,
)
from ldpc_tpu_torch.ops.qam_channel import QAM_CHANNEL, QAMChannel
from ldpc_tpu_torch.ops.qc_kernels import QC_KERNEL, QCDecoder
from ldpc_tpu_torch.ops.spa import make_decoder
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.sim.results import (
    SimulationConfig,
    SimulationResult,
    SNRPointResult,
)
from ldpc_tpu_torch.utils import timing
from ldpc_tpu_torch.utils.db import resolve_matrix
from ldpc_tpu_torch.utils.device import resolve_device

_M64 = (1 << 64) - 1
# the trip model's terms an ``auto.probe`` span carries
PROBE_TERMS = ("single", "phase1_mean", "phase2_per_tile", "overhead_trips")


@lru_cache(maxsize=16)
@timing.traced("code.load")
def load_code(path: str) -> LDPCCode:
    """Load a code from a file path, database basename, or built-in name
    (see ldpc_tpu_torch.utils.db.resolve_matrix)."""
    resolved = resolve_matrix(path)
    if resolved.startswith("builtin:"):
        name = resolved[len("builtin:"):]
        return LDPCCode(alist=standards.make_builtin(name), name=name)
    return LDPCCode(resolved)


def resolve_layer_groups(qc, opts, schedule: str) -> list[list[int]] | None:
    """Layer groups for the paired layered sweep, or None for serial
    (pairing off, not layered, not QC, or no disjoint pair exists)."""
    if getattr(opts, "layer_order", "serial") != "paired":
        return None
    if schedule != "layered" or qc is None:
        return None
    groups = paired_layer_groups(qc)
    if all(len(g) == 1 for g in groups):
        return None
    return groups


def resolve_two_phase(two_phase: str | int, max_iterations: int,
                      check_every: int = 1) -> int:
    """Phase-1 iteration count for two-phase dispatch, or 0 for off.

    'auto' splits the budget in half once there is enough of one to split
    (>= 8 iterations), rounded down to a multiple of ``check_every``; an
    explicit N must satisfy 0 < N < max_iterations and be a multiple of
    ``check_every`` (convergence is detected only at check boundaries)."""
    if two_phase in ("off", "0", 0):
        return 0
    if two_phase == "auto":
        p1 = max_iterations // 2 if max_iterations >= 8 else 0
        return p1 - (p1 % check_every)
    try:
        n = int(two_phase)
    except (TypeError, ValueError):
        raise ValueError(
            f"--two-phase must be 'auto', 'off' or an integer: {two_phase!r}"
        ) from None
    if not 0 < n < max_iterations:
        raise ValueError(
            f"--two-phase phase-1 iterations must be in (0, max_iterations="
            f"{max_iterations}): {n}"
        )
    if n % check_every:
        raise ValueError(
            f"--two-phase {n} must be a multiple of --check-every "
            f"{check_every}: convergence is only detected at check "
            "boundaries"
        )
    return n


def two_phase_trip_model(
    conv: np.ndarray, ok: np.ndarray, phase1: int, max_iterations: int,
    lanes: int = 128,
) -> dict:
    """Predicted mean loop trips per block of ``lanes`` codewords for both
    dispatch modes, from one batch's per-frame convergence iterations
    (``runner.py:128-177`` of the JAX package, unchanged).

    A lane's trip count is conv_iter+1 if it converged else max_iterations,
    and a block's is the max over its lanes. ``single``: mean block trips
    of a single pass; ``phase1_mean``: the same blocks capped at phase 1;
    ``phase2_per_tile``: re-decode trips of the unconverged lanes grouped
    ``lanes`` at a time in original order (what the stable compaction
    produces), amortized over all blocks; ``refeed_frac``: fraction of
    lanes phase 1 leaves unconverged."""
    trips = np.where(ok, conv.astype(np.int64) + 1, max_iterations)
    if trips.size >= lanes:
        trips = trips[: (trips.size // lanes) * lanes]
        tiles = trips.reshape(-1, lanes)
    else:
        tiles = trips.reshape(1, -1)
    ntiles = tiles.shape[0]
    t_single = tiles.max(axis=1)
    refeed = trips[trips > phase1]
    phase2_sum, n_groups = 0.0, 0
    for g in range(0, refeed.size, lanes):
        phase2_sum += float(refeed[g:g + lanes].max())
        n_groups += 1
    return {
        "single": float(t_single.mean()),
        "phase1_mean": float(np.minimum(t_single, phase1).mean()),
        "phase2_per_tile": phase2_sum / ntiles,
        "refeed_frac": refeed.size / max(trips.size, 1),
        "refeed_tile_frac": n_groups / ntiles,
    }


def _mix(x: int) -> int:
    """splitmix64 finalizer: a 64-bit word from a 64-bit word."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def derive_key(key: int, index: int) -> int:
    """The key of child ``index`` of ``key`` (point of a run, batch of a
    point): a pure function, so any split of a run draws the same words."""
    return _mix(_mix(int(key) & _M64) ^ (int(index) & _M64))


KNOWN_LLR = 60.0  # |LLR| of a known bit; channel convention: 0 -> negative

# the JAX runner's refusal of fused='on' (runner.py:577-585), word for word
FUSED_ON_TEXT = (
    "fused='on' requires a QC code, check_rule='exact', "
    "decode_graph='orig', an SPA/min-sum variant, "
    "no interleaver, modulation 1/2, no "
    "shorten/puncture, a mesh with a batch axis (or none) "
    "outside the parallel sweep, and the kernel fitting VMEM "
    "(--normalized-llr adds a scratch buffer to the VMEM plan)"
)


@dataclass(frozen=True)
class Route:
    """Where one configuration runs (:func:`choose_route`)."""

    code: LDPCCode
    opts: SimOptions
    device: torch.device
    fused: bool  # the fused path runs
    decoder: str  # the unfused path's: 'qc' (K3), 'layered' or 'flooding'
    layer_groups: list[list[int]] | None
    phase1: int  # the fused path's two-phase split, 0 for a single pass
    kernel: str  # ``kernel_used`` without the run loop's ``+2phase(...)``

    @property
    def loop_kw(self) -> dict:
        """The decode loop's settings, as K1, K2 and K3 take them."""
        o = self.opts
        return dict(alpha=o.minsum_alpha, beta=o.minsum_beta,
                    schedule=o.schedule or "flooding",
                    layer_groups=self.layer_groups, check_every=o.check_every,
                    track_norm=o.normalized_llr, msg_store=o.msg_store)

    def unfused_decoder(self, info_pos, max_iterations: int):
        """The unfused path's decoder over ``info_pos`` (the plain layered
        decoder takes the paired order flattened)."""
        code, o, variant = self.code, self.opts, self.opts.decoder_variant
        if self.decoder == "qc":
            return QCDecoder(code.qc, info_pos, max_iterations, variant,
                             **self.loop_kw)
        if self.decoder == "layered":
            groups = self.layer_groups
            return make_qc_layered_decoder(
                code.qc, info_pos, max_iterations, variant,
                alpha=o.minsum_alpha, beta=o.minsum_beta,
                layer_order=(None if groups is None
                             else [bi for g in groups for bi in g]),
                device=self.device)
        return make_decoder(code.layout(o.decode_graph), info_pos,
                            max_iterations, variant, rule=o.check_rule,
                            alpha=o.minsum_alpha, beta=o.minsum_beta,
                            device=self.device)


def choose_route(code: LDPCCode, opts: SimOptions, device: torch.device,
                 max_iterations: int, modulation: int, interleaver: str, *,
                 mesh=None, batch_axes: tuple[str, ...] = (),
                 step_vmapped: bool = False) -> Route:
    """The route of one configuration (``opts`` resolved; ``batch_axes``:
    the mesh's axes that shard the batch): whether the fused path runs, the
    unfused path's decoder, the layer groups, the two-phase split and the
    ``kernel_used`` base, with the JAX runner's refusals
    (``runner.py:237-388, 413-600``)."""
    variant, schedule = opts.decoder_variant, opts.schedule or "flooding"
    if modulation in (4, 16, 64) and opts.noise_model == "legacy":
        raise ValueError(
            "QAM modulations require noise_model='exact' (use --fidelity "
            "exact or --noise-model exact): the legacy sigma^2-as-stddev "
            "quirk is BPSK-specific and would make the SNR axis "
            "incomparable"
        )
    if np.ndim(opts.minsum_alpha) > 0 and variant != "normalized_minsum":
        raise ValueError(
            "a per-iteration --minsum-alpha schedule requires "
            "--decoder normalized-minsum"
        )
    if opts.msg_store == "int8" and variant not in (
            "minsum", "normalized_minsum", "offset_minsum"):
        raise ValueError(
            "--msg-store int8 requires a min-sum decoder variant (the SPA "
            "tanh rule loses FER under message quantization, "
            "examples/quantized_messages)"
        )
    S, P = opts.shorten, opts.puncture
    if not 0 <= S < code.k:
        raise ValueError(f"shorten={S} out of range [0, k={code.k})")
    n_parity = code.n - code.k
    if not 0 <= P < n_parity:
        raise ValueError(f"puncture={P} out of range [0, n-k={n_parity})")
    # the split, resolved for every configuration (runner.py:541-559)
    phase1 = resolve_two_phase(opts.two_phase, max_iterations,
                               opts.check_every)
    if phase1 and opts.normalized_llr:
        # the norm-LLR sum is a float accumulator the JAX package refuses
        # to split; 'auto' runs a single pass
        if opts.two_phase != "auto":
            raise ValueError(
                f"--two-phase {opts.two_phase} cannot be combined with "
                "--normalized-llr: the norm-LLR sum is a float "
                "accumulator that is not bit-stable across dispatch "
                "modes (measured on TPU, parity_runs/tpu_two_phase."
                "json); use --two-phase off"
            )
        phase1 = 0
    # what the QC kernels (K1-K3) take of the code and decoder
    qc_terms = (
        ("a quasi-cyclic code", code.qc is None),
        ("check_rule='exact'", opts.check_rule != "exact"),
        ("decode_graph='orig'", opts.decode_graph not in ("orig", "original")),
        ("an SPA/min-sum decoder", variant not in VARIANTS),
    )
    missing = tuple(what for what, bad in (
        ("fused != 'off'", opts.fused == "off"),
        ("kernel 'auto' or 'pallas'", opts.kernel not in ("auto", "pallas")),
        *qc_terms,
        ("no interleaver", interleaver != "none"),
        ("modulation 1 or 2", modulation not in (1, 2)),
        ("channel mode 1-3", opts.mode not in (1, 2, 3)),
        ("no shorten/puncture", bool(S or P)),
        ("a mesh with a batch axis (or none) outside the parallel sweep",
         mesh is not None and (not batch_axes or step_vmapped)),
    ) if bad)
    if opts.fused == "on" and missing:
        raise ValueError(FUSED_ON_TEXT + f" (missing: {', '.join(missing)})")
    if opts.kernel not in ("auto", "pallas", "xla"):
        raise ValueError(f"Unknown kernel: {opts.kernel!r}")
    eligible = not any(bad for _, bad in qc_terms)
    use_qc = eligible and opts.kernel in ("auto", "pallas")
    if opts.kernel == "pallas" and not eligible:
        raise ValueError(
            "kernel='pallas' requires a quasi-cyclic code, check_rule='exact', "
            "decode_graph='orig' and an SPA/min-sum variant"
        )
    if schedule == "layered" and not eligible:
        raise ValueError(
            "schedule='layered' requires a quasi-cyclic code, "
            "check_rule='exact', decode_graph='orig' and an SPA/min-sum "
            "variant (base rows are the layers)"
        )
    if opts.msg_store == "int8" and not use_qc:
        raise ValueError(
            "--msg-store int8 is a Pallas-kernel storage knob: it requires "
            "a configuration the QC kernel accepts (QC code, "
            "check_rule='exact', decode_graph='orig', min-sum variant, "
            "kernel 'auto' on TPU or 'pallas')"
        )
    if opts.check_every > 1 and not use_qc:
        raise ValueError(
            "--check-every > 1 is a Pallas decode-loop knob: it requires a "
            "configuration the QC kernel accepts (QC code, "
            "check_rule='exact', decode_graph='orig', SPA/min-sum variant, "
            "kernel 'auto' on TPU or 'pallas')"
        )
    groups = resolve_layer_groups(code.qc, opts, schedule)
    where = "cuda" if device.type == "cuda" else "cpu"
    kernel = (where + "+fused" if not missing else where if use_qc
              else "torch") \
        + ("+layered" if schedule == "layered" else "") \
        + ("+paired" if groups is not None else "") \
        + (f"+ce{opts.check_every}" if opts.check_every > 1 else "")
    return Route(code, opts, device, not missing,
                 "qc" if use_qc else schedule, groups,
                 0 if missing else phase1, kernel)


@dataclass
class PointStats:
    """Host-side aggregate for one SNR point (BlockCounters' fields)."""

    blocks: int = 0
    ok_blocks: int = 0
    error_bits: int = 0
    fer_frames: int = 0
    norm_llr_sum: float = 0.0
    conv_iters_sum: int = 0
    conv_count: int = 0

    def add(self, totals) -> int:
        """Add fetched totals (:func:`~ldpc_tpu_torch.ops.metrics.
        unpack_counters` reads them); returns their iterations."""
        counters, iters = unpack_counters(totals)
        for name, x in counters._asdict().items():
            now = getattr(self, name)
            setattr(self, name, now + type(now)(x))
        return iters


class PointExecutor:
    """The Monte-Carlo step of one (code, iterations, interleaver,
    modulation, decoder) configuration, reusable across SNR points: the
    fused path when the configuration is eligible, else the unfused one.

    ``device=None`` means the card (and raises without CUDA); the tests pass
    ``device="cpu"``, which runs the kernels' plain versions."""

    @timing.traced("executor.build")
    def __init__(self, code: LDPCCode, opts: SimOptions, *,
                 max_iterations: int | None = None,
                 interleaver: str | None = None,
                 modulation: int | None = None,
                 device: str | torch.device | None = None,
                 mesh=None, batch_axes: tuple[str, ...] = ("batch",),
                 step_vmapped: bool = False):
        opts = opts.resolved()
        self.device = resolve_device(device)
        self.code = code
        self.opts = opts
        self.graph = opts.decode_graph
        self.max_iterations = max_iterations or opts.iterations
        il_kind = interleaver if interleaver is not None else opts.interleaver
        self.modulation = modulation or opts.modulation
        self.batch = opts.auto_batch(code.n)
        # a mesh shards the batch over the axes it has of ``batch_axes``
        # (an snr-only mesh leaves it whole): the batch rounds up to a
        # multiple of their ranks, each rank decodes its rows of every
        # batch and the counters are summed over them (runner.py:447-456)
        self.mesh = mesh
        self._batch_axes = () if mesh is None else tuple(
            a for a in batch_axes if a in mesh.axis_names)
        shards = mesh.size(self._batch_axes) if self._batch_axes else 1
        self.batch = -(-self.batch // shards) * shards
        self.local_batch = self.batch // shards
        lo = (mesh.index(self._batch_axes) if self._batch_axes else 0) \
            * self.local_batch
        self._rows = (lo, lo + self.local_batch)
        self._sharded = shards > 1
        self.route = choose_route(
            code, opts, self.device, self.max_iterations, self.modulation,
            il_kind, mesh=mesh, batch_axes=self._batch_axes,
            step_vmapped=step_vmapped)
        self.fused, self.phase1 = self.route.fused, self.route.phase1
        self.kernel_used = self.route.kernel
        self.schedule = self.route.loop_kw["schedule"]
        timing.annotate(schedule=self.schedule)

        spec = code.encode_spec(opts.encoding_method, opts.ru_gap)
        info_pos = spec.info_pos(self.graph)
        # rate adaptation: shorten the LAST S info bits (known zeros at the
        # receiver), puncture the LAST P parity positions (erasures)
        S, P = opts.shorten, opts.puncture
        self.k_active = code.k - S
        self.effective_rate = self.k_active / max(code.n - S - P, 1)
        if (S or P) and abs(opts.speed - self.effective_rate) > 1e-9 \
                and not opts.quiet:
            print(
                f"Note: shorten/puncture give an effective rate of "
                f"{self.effective_rate:.4f} but the Eb/N0 scaling uses "
                f"--speed {opts.speed:g}; pass --speed "
                f"{self.effective_rate:.6g} if the SNR axis should be "
                f"per-info-bit of the adapted code"
            )

        self._auto = False
        # the fused path at more than one codeword a block counts each
        # call's lane trips (its codewords' block trips, or, where K1
        # refills, their own trips and the launch's tail idle)
        self._lane_trips = False
        # bytes of the X rows of one flooding K1 or K2 launch (0 elsewhere)
        self._x_row = 0
        self.last_probe: dict = {}
        self._two_phase_choice: dict[float, bool] = {}
        self._overhead_us = None
        self._consts_cache: dict[float, torch.Tensor] = {}
        self.total_iters_run = 0
        if self.fused:
            self._build_fused(spec, info_pos)
        else:
            self._build_unfused(spec, info_pos, il_kind)

    def _build_fused(self, spec, info_pos):
        """Fused pipeline: encode, then the fused Monte-Carlo kernel."""
        code, opts, variant = self.code, self.opts, self.opts.decoder_variant
        self._encode_T = make_encoder_T(spec, self.graph, self.device)
        loop_kw = self.route.loop_kw
        mc_kw = dict(mode=opts.mode, modulation=self.modulation, **loop_kw)
        self._mc_full = MCDecoder(code.qc, info_pos, self.max_iterations,
                                  variant, **mc_kw)
        self.lanes = self._mc_full.lanes
        self._lane_trips = self.lanes > 1
        if self._mc_full.flood:  # f32 [local batch, n] (``_buffers``)
            self._x_row = 4 * code.n * self.local_batch
        if self.phase1:
            self._mc1 = MCDecoder(code.qc, info_pos, self.phase1, variant,
                                  emit_llr=True, **mc_kw)
            self._llr_dec = LLRDecoder(code.qc, info_pos, self.max_iterations,
                                       variant, **loop_kw)
        self._auto = bool(self.phase1) and opts.two_phase == "auto"
        if self._auto:
            self.kernel_used += "+2phase(auto)"
            if self.device.type == "cuda":
                self._overhead_us = self._measure_overhead()
        elif self.phase1:
            self.kernel_used += f"+2phase({self.phase1})"

    def _build_unfused(self, spec, info_pos, il_kind):
        """Unfused pipeline (``runner.py:891-946``): encode, interleave,
        channel, deinterleave, puncture/shorten, the route's decoder,
        stats."""
        code, opts, dev = self.code, self.opts, self.device
        P = opts.puncture
        n_parity = code.n - code.k
        short_pos = np.asarray(info_pos[self.k_active:], dtype=np.int64)
        parity_pos = np.setdiff1d(np.arange(code.n, dtype=np.int64),
                                  np.asarray(info_pos, np.int64))
        punct_pos = parity_pos[n_parity - P:] if P else np.empty(0, np.int64)
        # decoder and metrics see only the active info bits
        info_pos = np.asarray(info_pos[:self.k_active], dtype=np.int64)
        self._info_pos = torch.as_tensor(info_pos, device=dev)
        llr_short = np.zeros((1, code.n), np.float32)
        llr_short[0, short_pos] = 1.0
        llr_punct = np.ones((1, code.n), np.float32)
        llr_punct[0, punct_pos] = 0.0
        self._llr_punct = torch.as_tensor(llr_punct, device=dev)
        self._llr_keep = torch.as_tensor(1.0 - llr_short, device=dev)
        self._llr_known = torch.as_tensor(KNOWN_LLR * llr_short, device=dev)
        self._encode = make_encoder(spec, self.graph, dev)
        if self.modulation in (4, 16, 64):  # one kernel on the card (K6)
            self._qam = QAMChannel(opts.mode, self.modulation, code.n, il_kind,
                                   s_param=opts.s_param, seed=opts.seed,
                                   device=dev)
            # the plain pieces stay for step's llr= injection
            self._interleave, self._deinterleave = (self._qam.interleave,
                                                    self._qam.deinterleave)
        else:
            self._qam = None
            self._interleave, self._deinterleave = make_interleaver(
                il_kind, code.n, s_param=opts.s_param, seed=opts.seed,
                device=dev)
            self._channel = make_channel_fn(opts.mode, self.modulation,
                                            n=code.n)
        self._decoder = self.route.unfused_decoder(info_pos,
                                                   self.max_iterations)

    # ------------------------------------------------------------ batches --

    def _words(self, key: int):
        """(generator of the info bits, Philox key words) of one fused
        batch."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_mix(key ^ 1) >> 1)
        k = _mix(key ^ 2)
        return gen, (k & 0xFFFFFFFF, k >> 32)

    def _decode(self, wT, consts, seeds, raw, p1: int, b0: int = 0,
                idle=None):
        """Per-codeword (err, ok, conv, norm, iters) of one batch's rows
        from ``b0`` at phase-1 split ``p1`` (0 = single pass)."""
        if not p1:
            return self._mc_full(wT, consts, seeds=seeds, raw=raw, b0=b0,
                                 idle=idle)
        with timing.batch_span("batch.phase1"):
            err1, ok1, conv1, norm1, it1, llrT = self._mc1(
                wT, consts, seeds=seeds, raw=raw, b0=b0)
        with timing.batch_span("batch.compact"):
            # compact unconverged frames to the front lanes: keys 0 before 1
            order = torch.argsort(ok1.to(torch.int32), stable=True)
            llr_s = llrT.index_select(1, order)
            w_s = wT.index_select(1, order)
            done0 = ok1.index_select(0, order).to(torch.float32)
        with timing.batch_span("batch.phase2"):
            err2, ok2, conv2, norm2, it2 = self._llr_dec(llr_s, w_s, done0)

        def unsort(x):
            return torch.empty_like(x).index_copy_(0, order, x)

        with timing.batch_span("batch.merge"):
            err = torch.where(ok1, err1, unsort(err2))
            conv = torch.where(ok1, conv1, unsort(conv2))
            norm = torch.where(ok1, norm1, unsort(norm2))
            ok = ok1 | unsort(ok2)
            # the trips of the two phases add (a re-decoded frame's block ran
            # it1 then it2 trips; a converged frame may inherit its phase-2
            # block's)
            iters = it1 + unsort(it2)
        return err, ok, conv, norm, iters

    def _generator(self, key: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(key >> 1)
        return gen

    def step(self, key: int, consts: torch.Tensor, p1: int = 0, *,
             u: torch.Tensor | None = None, raw: torch.Tensor | None = None,
             llr: torch.Tensor | None = None,
             idle: torch.Tensor | None = None):
        """One batch: ``(BlockStats, iters)`` (per-codeword trip counts on
        the fused path, the batch's ``iters_run`` on the unfused one).

        ``idle`` (float64 [1] on the device) gets a single pass's tail idle
        added where K1 refills (:class:`MCDecoder`).

        ``u`` (uint8 [batch, k]) replaces the batch's drawn info bits;
        ``raw`` (fused: noise words in the injected layout) and ``llr``
        (unfused: f32 [batch, n] channel output, before deinterleaving)
        replace its noise, for tests that feed both packages the same
        inputs."""
        if not self.fused:
            return self._unfused_step(key, consts, u=u, llr=llr)
        with timing.batch_span("batch.draw"):
            gen, seeds = self._words(key)
            if u is None:
                u = random_info_bits(gen, self.batch, self.code.k)
        lo, hi = self._rows
        if raw is not None and self._sharded:
            raw = raw[:, :, lo:hi].contiguous()
        with timing.batch_span("batch.encode"):
            wT = self._encode_T(u[lo:hi])
        with timing.batch_span("batch.decode"):
            err, ok, conv, norm, iters = self._decode(wT, consts, seeds, raw,
                                                      p1, lo, idle)
        return BlockStats(
            error_bits=failed_frame_errors(err, ok, self.opts.exact_ber),
            ok=ok, conv_iter=conv, norm_llr=norm), iters

    def _unfused_step(self, key: int, consts: torch.Tensor, *,
                      u: torch.Tensor | None = None,
                      llr: torch.Tensor | None = None):
        u, _, llr = self._draw(key, consts, u=u, llr=llr)
        with timing.batch_span("batch.decode"):
            res = self._decoder(llr)
        with timing.batch_span("batch.counters"):
            return self._stats(u, res), res.iters_run

    def pattern_step(self, key: int, consts: torch.Tensor):
        """One unfused batch with its residual error vectors: ``(stats,
        iters, resid)``, ``resid`` uint8 [B, n] = est XOR the sent codeword
        (``runner.py:933-939``). The codeword is valid, so H @ resid = H @
        est: a detected failure's support is a trapping-set candidate."""
        if self.fused:
            raise ValueError(
                "pattern capture needs the unfused pipeline: build the "
                "PointExecutor with fused='off'"
            )
        u, w, llr = self._draw(key, consts)
        res = self._decoder(llr)
        return self._stats(u, res), res.iters_run, res.est ^ w.to(res.est.dtype)

    def _stats(self, u: torch.Tensor, res) -> BlockStats:
        return block_stats(u[:, :self.k_active], res, self._info_pos,
                           exact=self.opts.exact_ber)

    def _draw(self, key: int, consts: torch.Tensor, *,
              u: torch.Tensor | None = None, llr: torch.Tensor | None = None):
        """(info bits, codewords, decoder input LLRs) of this rank's rows
        of one unfused batch. The whole batch is drawn on every rank, so a
        shard decodes the frames a single process decodes there."""
        with timing.batch_span("batch.draw"):
            if u is None:
                u = random_info_bits(self._generator(derive_key(key, 0)),
                                     self.batch, self.code.k)
            if self.opts.shorten:
                u = u.clone()
                u[:, self.k_active:] = 0
        with timing.batch_span("batch.encode"):
            w = self._encode(u)
        with timing.batch_span("batch.channel"):
            gen_il = self._generator(derive_key(key, 1))
            if llr is None and self._qam is not None:
                llr = self._qam(gen_il, self._generator(derive_key(key, 2)), w,
                                consts)
            else:
                w_int, il_state = self._interleave(gen_il, w)
                if llr is None:
                    llr = self._channel(self._generator(derive_key(key, 2)),
                                        w_int, consts)
                llr = self._deinterleave(il_state, llr)
            if self.opts.puncture:  # punctured parity bits arrive as erasures
                llr = llr * self._llr_punct
            if self.opts.shorten:  # shortened info bits are known zeros
                llr = llr * self._llr_keep - self._llr_known
        lo, hi = self._rows
        return u[lo:hi], w[lo:hi], llr[lo:hi].contiguous()

    def sweep_step(self, keys, consts, skips):
        """Several SNR points as one step (the unfused path; the parallel
        sweep's counterpart of ``jax.vmap(self._step)``): point ``i`` draws
        batch key ``keys[i]`` at ``consts[i]`` unless ``skips[i]``.

        Returns ``(BlockStats[S, B_local], iters[S])``. The QC decoder takes
        the active points' LLRs in one launch, ``[S_active * B_local, n]``;
        each point's ``iters`` is the most trips of its rows' blocks. A
        skipped point is left out of the launch: its iters are 0 and its
        stats placeholders (ok, no errors) the caller discards. The other
        decoders take one point at a time."""
        if self.fused:
            raise ValueError("sweep_step runs the unfused path (a step "
                             "built with step_vmapped=True)")
        Bl, dev = self.local_batch, self.device
        active = [i for i, s in enumerate(skips) if not s]
        draws = [self._draw(keys[i], consts[i]) for i in active]
        results = {}
        if self.route.decoder == "qc" and active:
            outs = self._decoder.outputs(torch.cat([d[2] for d in draws]))
            for j, i in enumerate(active):
                rows = [x[j * Bl:(j + 1) * Bl] for x in outs]
                results[i] = QCDecoder._result(*rows)
        else:
            for (_, _, llr), i in zip(draws, active):
                results[i] = self._decoder(llr)
        stats, iters = [], []
        for i in range(len(keys)):
            if i in results:
                u = draws[active.index(i)][0]
                stats.append(self._stats(u, results[i]))
                iters.append(results[i].iters_run.to(torch.int32).reshape(()))
            else:
                stats.append(BlockStats(
                    error_bits=torch.zeros(Bl, dtype=torch.int32, device=dev),
                    ok=torch.ones(Bl, dtype=torch.bool, device=dev),
                    conv_iter=torch.full((Bl,), -1, dtype=torch.int32,
                                         device=dev),
                    norm_llr=torch.zeros(Bl, dtype=torch.float32, device=dev)))
                iters.append(torch.zeros((), dtype=torch.int32, device=dev))
        return (BlockStats(*(torch.stack(x) for x in zip(*stats))),
                torch.stack(iters))

    def packed(self, stats: BlockStats, iters: torch.Tensor,
               take: int) -> torch.Tensor:
        """int32[8] counters of this rank's rows among the first ``take``
        codewords of a batch (one K7 launch on the card)."""
        return batch_counters(stats, iters, self._rows[0], take)

    # ----------------------------------------------------------- two-phase --

    @timing.traced("auto.measure")
    def _measure_overhead(self) -> float:
        """Device time (us) of what a split adds per batch: the sort, the
        gathers, the scatters back and one LLR-kernel launch on a batch that
        is all done. Measured once per executor (warm, best of three).

        One discarded single-pass batch runs first, so that one-time costs
        (library handles, kernel loading) fall neither here nor on the
        probe that prices a block trip."""
        n, B = self.code.n, self.local_batch
        dev = self.device
        timing.count("measures")
        self.step(derive_key(self.opts.seed, 1 << 40), self.consts(0.0), 0)
        wT = torch.zeros((n, B), dtype=torch.float32, device=dev)
        llrT = torch.zeros_like(wT)
        ok1 = torch.ones(B, dtype=torch.bool, device=dev)
        best = float("inf")
        for _ in range(3):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            order = torch.argsort(ok1.to(torch.int32), stable=True)
            outs = self._llr_dec(llrT.index_select(1, order),
                                 wT.index_select(1, order),
                                 ok1.index_select(0, order).to(torch.float32))
            for x in outs:
                torch.empty_like(x).index_copy_(0, order, x)
            t1.record()
            t1.synchronize()
            best = min(best, t0.elapsed_time(t1) * 1e3)
        return best

    def _decide_two_phase(self, conv: np.ndarray, ok: np.ndarray,
                          trip_us: float | None = None) -> bool:
        """Whether two-phase dispatch beats a single pass at this operating
        point, from one probe batch's per-frame convergence (counters are
        the same either way, so the probe is production output).

        On the card: two-phase wins when ``phase1_mean + phase2_per_tile +
        overhead / trip_time < single``, with the trip time the probe's own
        device time over its mean block trips and the overhead measured once
        per executor (:meth:`_measure_overhead`). On the CPU nothing is
        timed, and the rule is the trip model with no overhead: split when
        it predicts fewer mean block trips."""
        m = two_phase_trip_model(conv, ok, self.phase1, self.max_iterations,
                                 lanes=self.lanes)
        extra = 0.0
        if trip_us is not None and self._overhead_us is not None:
            extra = self._overhead_us / max(trip_us, 1e-6)
        self.last_probe = dict(m, overhead_trips=extra, trip_us=trip_us,
                               overhead_us=self._overhead_us)
        return m["phase1_mean"] + m["phase2_per_tile"] + extra < m["single"]

    # --------------------------------------------------------------- point --

    def consts(self, snr_db: float) -> torch.Tensor:
        c = self._consts_cache.get(snr_db)
        if c is None:
            c = ChannelParams(
                mode=self.opts.mode, modulation=self.modulation,
                speed=self.opts.speed, snr_db=snr_db,
                interference_snr_db=self.opts.interference_snr,
                p=self.opts.p, noise_model=self.opts.noise_model,
            ).consts(self.device)
            self._consts_cache[snr_db] = c
        return c

    @timing.traced("auto.probe")
    def _probe(self, key: int, consts: torch.Tensor, idle=None):
        """One single-pass batch (``idle`` as :meth:`step` takes it) whose
        convergence picks the dispatch mode; on the card its kernel time
        prices a block trip. Its span carries the choice (``split``), the
        block's ``lanes`` and the trip model's terms
        (:meth:`_decide_two_phase`), all host values."""
        cuda = self.device.type == "cuda"
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        stats, iters = self.step(key, consts, 0, idle=idle)
        trip_us = None
        if cuda:
            t1.record()
            t1.synchronize()
            batch_us = t0.elapsed_time(t1) * 1e3
        conv = stats.conv_iter.cpu().numpy()
        okv = stats.ok.cpu().numpy()
        timing.count("probes")
        timing.count("fetches", 2)
        if cuda:
            m = two_phase_trip_model(conv, okv, self.phase1,
                                     self.max_iterations, lanes=self.lanes)
            trip_us = batch_us / max(m["single"], 1e-9)
        use2 = self._decide_two_phase(conv, okv, trip_us)
        timing.annotate(lanes=self.lanes, split=int(use2),
                        **{k: self.last_probe[k] for k in PROBE_TERMS})
        return stats, iters, use2

    def run_point(self, snr_db: float, blocks: int, base_key: int | None = None,
                  point_index: int = 0, *, start_batch: int = 0) -> PointStats:
        """Stream Monte-Carlo batches for one SNR point.

        Batch ``i`` of the point draws from ``derive_key(point key, i)``, so
        ``run_point(s, a + b)`` equals ``run_point(s, a)`` followed by
        ``run_point(s, b, start_batch=a // batch)`` when ``a`` is a whole
        number of batches.

        The unit's root span carries the ``schedule`` decoded and the
        counters ``batches``, ``frames``, ``fetches``; ``x_row_bytes`` on
        the fused path under flooding (4 n bytes, the f32 row of channel
        LLRs that K1 writes and re-reads each sweep, for each row of every
        batch's K1 launch and a split batch's K2 launch, the probe's batch
        included; counted on the host from the batches); ``split_batches`` (the batches run as a split) where a
        split is possible; ``lane_trips`` (every sweep of every codeword's
        lanes: its block's trips, or, where K1 refills, its own trips and
        each launch's tail idle; summed on the card and read by the flush's
        fetch) where a block holds more than one codeword, and ``refills``
        (codewords a lane group loaded after its first, from each single
        pass's grid; 0 where the batch fits one wave) where K1 can refill.
        A partial last batch adds the trips of its counted rows only, but
        where K1 refills, the tail idle of its whole launch."""
        with timing.span("run_point", snr=snr_db, schedule=self.schedule):
            consts = self.consts(snr_db)
            key_point = derive_key(
                self.opts.seed if base_key is None else base_key, point_index)
            B = self.batch
            # the batch counters' totals, then this rank's lane trips
            acc = torch.zeros(len(SLOTS) + self._lane_trips,
                              dtype=torch.float64, device=self.device)
            idle = acc[len(SLOTS):] if self._lane_trips else None
            stats = PointStats()
            remaining = blocks
            batch_idx = start_batch
            target = self.opts.target_errors

            def add(s, it, take: int) -> None:
                nonlocal remaining, batch_idx
                with timing.batch_span("batch.counters"):
                    add_packed(acc, self.packed(s, it, take))
                    if self._lane_trips:  # this rank's rows below take
                        idle.add_(it[:max(take - self._rows[0], 0)].sum())
                remaining -= take
                batch_idx += 1

            def flush():
                with timing.span("flush"):
                    v = acc.tolist()  # the one host fetch
                    if self._sharded:
                        # the batch's counters and trips, summed over its
                        # shards; the decode's iterations stay this rank's
                        tot = self.mesh.all_reduce(
                            acc, self._batch_axes).tolist()
                        v = [x if f == "iters" else t for f, x, t
                             in zip(SLOTS + ("trips",), v, tot)]
                    acc.zero_()
                    self.total_iters_run += stats.add(v)
                    if self._lane_trips:
                        timing.count("lane_trips", int(v[len(SLOTS)]))
                timing.count("fetches", 2 if self._sharded else 1)

            def batches(count: int) -> None:
                nonlocal split
                for _ in range(count):
                    take = min(remaining, B)
                    add(*self.step(derive_key(key_point, batch_idx), consts,
                                   p1, idle=idle), take)
                if p1:
                    split += count

            split = 0  # batches run as a split
            p1 = self.phase1
            if self._auto and remaining > 0:
                use2 = self._two_phase_choice.get(snr_db)
                if use2 is None:
                    s, it, use2 = self._probe(derive_key(key_point, batch_idx),
                                              consts, idle)
                    add(s, it, min(remaining, B))
                    self._two_phase_choice[snr_db] = use2
                self.kernel_used = self.route.kernel + (
                    f"+2phase(auto:{self.phase1})" if use2
                    else "+2phase(auto:off)")
                p1 = self.phase1 if use2 else 0
            if not target:
                batches(-(-remaining // B))
                flush()
            else:
                # the sequential MC early stop, on the JAX runner's schedule
                # (runner.py:1047-1091): where its fused path runs (the card,
                # or fused='on'), the quota is checked after groups of up to
                # 8 batches, a power of two, while two batches remain; then,
                # and on the unfused path, after every batch
                flush()
                if self.fused and (self.device.type == "cuda"
                                   or self.opts.fused == "on"):
                    while remaining >= 2 * B and stats.fer_frames < target:
                        group = min(remaining // B, 8)
                        batches(1 << (group.bit_length() - 1))
                        flush()
                while remaining > 0 and stats.fer_frames < target:
                    batches(1)
                    flush()
            timing.count("batches", batch_idx - start_batch)
            timing.count("frames", blocks - remaining)
            if self.phase1:
                timing.count("split_batches", split)
            if self._x_row:
                timing.count("x_row_bytes",
                             self._x_row * (batch_idx - start_batch + split))
            if self.fused and self._mc_full.refill:
                # a launch's, in each single-pass batch
                timing.count("refills", self._mc_full.refills(
                    self.local_batch, self.device)
                    * (batch_idx - start_batch - split))
            return stats


# ------------------------------------------------------------------ sweep ----

def snr_steps(initial: float, end: float, step: float) -> list[float]:
    """SNR grid with the reference's stepping (main.py:193, 206-209),
    validated and de-duplicated (``runner.py:1095-1114``)."""
    if step <= 0:
        raise ValueError(f"step_snr must be positive, got {step}")
    if end < initial:
        raise ValueError(
            f"end_snr ({end}) must be >= initial_snr ({initial})"
        )
    num_steps = int(math.ceil((end - initial) / step)) + 1
    values: list[float] = []
    for i in range(num_steps):
        snr = min(initial + i * step, end)
        if not values or snr != values[-1]:
            values.append(snr)
    return values


def build_point_result(
    snr_db: float,
    stats: PointStats,
    opts: SimOptions,
    k: int,
    *,
    matrix_path: str | None = None,
    modulation: int | None = None,
    max_iterations: int | None = None,
    interleaver: str | None = None,
) -> SNRPointResult:
    """Aggregate counters into an SNRPointResult with the reference's
    averaging semantics (main.py:346-389)."""
    blocks = stats.blocks
    avg_ber = 0.0
    avg_fer = 0.0
    avg_llr = 0.0
    if opts.ber and blocks > 0 and k > 0:
        avg_ber = stats.error_bits / (k * blocks)
    if opts.fer and blocks > 0:
        avg_fer = stats.fer_frames / blocks
    if opts.normalized_llr and blocks > 0:
        avg_llr = stats.norm_llr_sum / blocks
    avg_conv = stats.conv_iters_sum / stats.conv_count if stats.conv_count else 0.0
    return SNRPointResult(
        snr_db=snr_db,
        ber=avg_ber,
        fer=avg_fer,
        avg_normalized_llr=avg_llr,
        total_blocks=blocks,
        successful_blocks=stats.ok_blocks,
        failed_blocks=blocks - stats.ok_blocks,
        avg_convergence_iterations=avg_conv,
        matrix_path=matrix_path if matrix_path is not None else opts.matrix,
        modulation=modulation if modulation is not None else opts.modulation,
        max_iterations=max_iterations if max_iterations is not None else opts.iterations,
        interleaver=interleaver if interleaver is not None else opts.interleaver,
        encoding_method=opts.encoding_method,
    )


def make_sim_config(opts: SimOptions, code: LDPCCode,
                    device: str | torch.device | None = None) -> SimulationConfig:
    """The run's configuration; ``device`` reads ``cuda:<card name>x1`` or
    ``cpu:x1`` (the port runs on one device)."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""
    return SimulationConfig(
        matrix_path=opts.matrix,
        n=code.n,
        m=code.m,
        k=code.k,
        rate=code.rate,
        blocks=opts.blocks,
        max_iterations=opts.iterations,
        encoding_method=opts.encoding_method,
        interleaver_type=opts.interleaver,
        decoder_type=opts.decoder,
        channel_mode=opts.mode,
        modulation=opts.modulation,
        speed=opts.speed,
        snr_range=(opts.initial_snr, opts.end_snr, opts.step_snr),
        threads=opts.threads,
        timestamp=datetime.now().isoformat(),
        interference_snr=opts.interference_snr,
        p=opts.p,
        fidelity=opts.fidelity,
        decode_graph=opts.decode_graph or "",
        check_rule=opts.check_rule or "",
        noise_model=opts.noise_model or "",
        batch=opts.batch,
        seed=opts.seed,
        device=f"{dev.type}:{name}x1",
        shorten=opts.shorten,
        puncture=opts.puncture,
        schedule=opts.schedule,
        s_param=opts.s_param,
        exact_ber=opts.exact_ber,
        adaptive=opts.adaptive,
        fused=opts.fused,
        layer_order=opts.layer_order,
        check_every=opts.check_every,
        sublane_groups=str(opts.sublane_groups),
    )


def sweep_fingerprint(config: SimulationConfig) -> tuple:
    """Sweep-defining identity of a run (``runner.py:1199-1231``): a
    checkpoint resumes only a sweep with identical code / stats / decoder
    configuration. Timestamp, device and wall clock are left out, and so is
    ``two_phase``, a dispatch knob with equal counters; ``batch``,
    ``layer_order`` and ``check_every`` change the frames or the schedule,
    so they are in."""
    return (
        config.matrix_path, config.n, config.m, config.k,
        config.blocks, config.max_iterations, config.encoding_method,
        config.interleaver_type, config.decoder_type, config.channel_mode,
        config.modulation, config.speed, tuple(config.snr_range),
        config.interference_snr, config.p, config.fidelity,
        config.decode_graph, config.check_rule, config.noise_model,
        config.seed, config.shorten, config.puncture, config.schedule,
        config.s_param, config.exact_ber, config.adaptive, config.fused,
        config.layer_order, config.check_every, config.sublane_groups,
        config.batch,
    )


def load_checkpoint(
    opts: SimOptions, config: SimulationConfig, say
) -> SimulationResult | None:
    """Prior partial result from opts.checkpoint, or None when absent/foreign."""
    if not (opts.checkpoint and opts.resume and os.path.exists(opts.checkpoint)):
        return None
    prior = SimulationResult.from_json(opts.checkpoint)
    if sweep_fingerprint(prior.config) != sweep_fingerprint(config):
        say(
            f"Checkpoint {opts.checkpoint} belongs to a different sweep "
            f"configuration; starting fresh."
        )
        return None
    say(f"Resuming from {opts.checkpoint}: {len(prior.snr_points)} points done")
    return prior


def _profiled_sweep(profile_dir: str | None, device: torch.device):
    """A ``torch.profiler`` trace of the sweep written to ``profile_dir``
    (TensorBoard layout, ``runner.py:1314`` ``_profiled_sweep``), host
    activity and, on the card, its kernels; no trace without a
    directory."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def run_simulation(
    opts: SimOptions,
    code: LDPCCode | None = None,
    mesh=None,
    device: str | torch.device | None = None,
) -> SimulationResult:
    """Full SNR sweep; returns a SimulationResult (``runner.py:1323-1402``).

    Point ``i`` draws from ``derive_key(opts.seed, i)``, so a sweep resumed
    from its checkpoint equals one that ran through. The results go to
    ``opts.output_json`` / ``opts.output_csv`` when set. ``mesh``
    (:func:`ldpc_tpu_torch.parallel.mesh.make_mesh`) shards each batch over
    its ``batch`` axis; the counters equal an unmeshed run's.
    ``device=None`` means the card. With ``opts.profile``, the recorded
    spans and counters (:mod:`ldpc_tpu_torch.utils.timing`) and the
    kernels' launch counts (K1-K3, K6-K8) go to ``<profile>/spans.json`` when
    the sweep ends."""
    with timing.span("run_simulation"):
        result = _sweep(opts, code, mesh, device)
    if opts.profile:
        os.makedirs(opts.profile, exist_ok=True)
        timing.RECORDER.export(
            os.path.join(opts.profile, "spans.json"),
            launches={k.symbol: k.launches
                      for k in (MC_KERNEL, LLR_KERNEL, QC_KERNEL,
                                QAM_CHANNEL, BATCH_COUNTERS, ADD_COUNTERS,
                                ENCODE)})
    return result


def _sweep(opts: SimOptions, code: LDPCCode | None, mesh,
           device) -> SimulationResult:
    opts = opts.resolved()
    device = resolve_device(device)
    start_time = time.time()
    if code is None:
        code = load_code(opts.matrix)

    say = (lambda *a, **kw: None) if opts.quiet else print
    config = make_sim_config(opts, code, device)
    prior = load_checkpoint(opts, config, say)
    snr_points: list[SNRPointResult] = list(prior.snr_points) if prior else []

    # the executor (GF(2) elimination, decoder tables) is built on demand: a
    # checkpoint that already covers the whole sweep skips it
    executor: PointExecutor | None = None

    say("Processing blocks across SNR points...")
    say("-" * 60)
    with _profiled_sweep(opts.profile, device):
        for idx, snr in enumerate(
            snr_steps(opts.initial_snr, opts.end_snr, opts.step_snr)
        ):
            if idx < len(snr_points):
                continue  # completed before resume
            if executor is None:
                executor = PointExecutor(code, opts, device=device, mesh=mesh)
            say(f"\nSNR: {snr:.2f} dB")
            with timing.span("point", snr=snr) as span:
                stats = executor.run_point(snr, opts.blocks, opts.seed, idx)
            point_s = span.seconds
            point = build_point_result(snr, stats, opts, executor.k_active)
            snr_points.append(point)
            if opts.normalized_llr:
                say(f"  Normalized LLR: {point.avg_normalized_llr:.6f}")
            if opts.fer:
                say(f"  FER: {point.fer:.6f}")
            if opts.ber:
                say(f"  BER: {point.ber:.6f}")
            say(
                f"  Decoded OK: {point.successful_blocks}/{point.total_blocks} "
                f"({100.0 * point.successful_blocks / max(point.total_blocks, 1):.2f}%)"
            )
            say(
                f"  Throughput: {stats.blocks / point_s:,.0f} codewords/s "
                f"({stats.blocks * code.k / point_s:,.0f} info bits/s)"
            )
            if opts.checkpoint:
                SimulationResult(
                    config=config,
                    snr_points=snr_points,
                    wall_clock_seconds=time.time() - start_time,
                ).to_json(opts.checkpoint)

    say()
    say("=" * 60)
    if opts.ber:
        say("SNR -> BER:")
        for p in snr_points:
            say(f"  {p.snr_db:.2f} dB -> {p.ber:.6f}")
    if opts.fer:
        say("SNR -> FER:")
        for p in snr_points:
            say(f"  {p.snr_db:.2f} dB -> {p.fer:.6f}")
    if opts.normalized_llr:
        say("SNR -> Normalized LLR:")
        for p in snr_points:
            say(f"  {p.snr_db:.2f} dB -> {p.avg_normalized_llr:.6f}")
    say("=" * 60)

    result = SimulationResult(
        config=config,
        snr_points=snr_points,
        wall_clock_seconds=time.time() - start_time,
    )
    if opts.output_json:
        result.to_json(opts.output_json)
    if opts.output_csv:
        result.to_csv(opts.output_csv)
    return result


# ---------------------------------------------------------- parallel sweep --

def _parallel_ckpt_save(path: str, fp, batch_idx: int, remaining: int,
                        stats_list, total_iters: int,
                        device_batch: int) -> None:
    """Atomic mid-sweep checkpoint of the parallel sweep (``runner.py:
    1253-1282``): the raw per-point counters and the stream position, with
    the resolved batch, which shapes the stream. Every rank writes its own
    file through a temporary of its own, with the same content."""
    payload = {
        "parallel_sweep": 1,
        "fingerprint": fp,
        "device_batch": device_batch,
        "batch_idx": batch_idx,
        "remaining": remaining,
        "total_iters_run": total_iters,
        "counters": [[getattr(s, f) for f in BlockCounters._fields]
                     for s in stats_list],
    }
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _parallel_ckpt_load(path: str, fp, n_points: int, say, device_batch: int):
    """A parallel-sweep checkpoint as ``(batch_idx, remaining,
    total_iters_run, stats_list)``; None when absent or foreign."""
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        d = json.load(f)
    if not d.get("parallel_sweep"):
        say(f"Checkpoint {path} is not a parallel-sweep checkpoint; "
            "starting fresh.")
        return None
    if (d["fingerprint"] != fp or len(d["counters"]) != n_points
            or d.get("device_batch") != device_batch):
        say(f"Checkpoint {path} belongs to a different sweep configuration; "
            "starting fresh.")
        return None
    stats_list = [PointStats(**dict(zip(BlockCounters._fields, row)))
                  for row in d["counters"]]
    say(f"Resuming parallel sweep from {path}: batch {d['batch_idx']}, "
        f"{d['remaining']} blocks/point remaining")
    return d["batch_idx"], d["remaining"], d["total_iters_run"], stats_list


def run_simulation_parallel(
    opts: SimOptions,
    code: LDPCCode | None = None,
    mesh=None,
    snr_axis: str = "snr",
    device: str | torch.device | None = None,
) -> SimulationResult:
    """SNR sweep with every point evaluated at once (``runner.py:
    1405-1549``).

    The points run as one step per batch index (:meth:`PointExecutor.
    sweep_step`: the QC decoder takes all their frames in one launch), dealt
    over the mesh's ``snr`` axis when it has one, each point's batch sharded
    over the other axes. The step is the unfused one (the JAX runner's
    vmapped step cannot take its fused kernel), so ``fused='on'`` raises.
    Keys derive as the sequential runner's, ``derive_key(derive_key(seed,
    point), batch)``, so the result equals ``run_simulation`` with
    ``fused='off'`` point for point. With ``--target-errors`` each point
    stops at its own quota: it is skip-masked from then on. The default mesh
    puts every rank on ``batch``."""
    from ldpc_tpu_torch.parallel.mesh import make_mesh, sharded_sweep_step

    opts = opts.resolved()
    device = resolve_device(device)
    start_time = time.time()
    if code is None:
        code = load_code(opts.matrix)
    if mesh is None:
        mesh = make_mesh()
    say = (lambda *a, **kw: None) if opts.quiet else print

    snrs = snr_steps(opts.initial_snr, opts.end_snr, opts.step_snr)
    S = len(snrs)
    s_shard = mesh.shape.get(snr_axis, 1)
    Sp = -(-S // s_shard) * s_shard  # points padded to the snr axis
    batch_axes = tuple(a for a in mesh.axis_names if a != snr_axis)
    executor = PointExecutor(code, opts, device=device, mesh=mesh,
                             batch_axes=batch_axes or ("batch",),
                             step_vmapped=True)
    padded = snrs + [snrs[-1]] * (Sp - S)
    consts = [executor.consts(s) for s in padded]
    point_keys = [derive_key(opts.seed, i) for i in range(Sp)]
    sweep = sharded_sweep_step(executor.sweep_step, mesh, snr_axis)
    B = executor.batch
    config = make_sim_config(opts, code, device)

    say(f"Evaluating {S} SNR points in parallel on mesh {mesh.shape}...")

    stats_list = [PointStats() for _ in range(Sp)]
    remaining = opts.blocks
    batch_idx = 0
    ckpt_fp = None
    if opts.checkpoint:
        # JSON-normalized so a reloaded fingerprint compares equal
        ckpt_fp = json.loads(json.dumps(sweep_fingerprint(config)))
        if opts.resume:
            prior = _parallel_ckpt_load(opts.checkpoint, ckpt_fp, Sp, say, B)
            if prior is not None:
                batch_idx, remaining, executor.total_iters_run, stats_list = prior

    def finished_mask() -> np.ndarray:
        """Points that stop decoding: the padding replicas always, real
        points once they reach the --target-errors quota (derived from the
        counters, so a resume recomputes it)."""
        f = np.zeros(Sp, dtype=bool)
        f[S:] = True
        if opts.target_errors:
            for s in range(S):
                f[s] = stats_list[s].fer_frames >= opts.target_errors
        return f

    with _profiled_sweep(opts.profile, device):
        while remaining > 0:
            finished = finished_mask()
            if opts.target_errors and finished[:S].all():
                break
            take = min(remaining, B)
            keys = [derive_key(k, batch_idx) for k in point_keys]
            stats, iters = sweep(keys, consts, finished.tolist())
            live = np.flatnonzero(~finished).tolist()
            totals = torch.zeros(len(live), len(SLOTS), dtype=torch.float64,
                                 device=device)
            add_packed(totals, torch.stack([
                batch_counters(BlockStats(*(x[s] for x in stats)), iters[s],
                               0, take)
                for s in live]))
            for s, row in zip(live, totals.tolist()):  # one fetch a batch
                executor.total_iters_run += stats_list[s].add(row)
            remaining -= take
            batch_idx += 1
            if opts.checkpoint:
                _parallel_ckpt_save(opts.checkpoint, ckpt_fp, batch_idx,
                                    remaining, stats_list,
                                    executor.total_iters_run, B)

    snr_points = [
        build_point_result(snrs[s], stats_list[s], opts, executor.k_active)
        for s in range(S)
    ]
    for p in snr_points:
        say(f"SNR {p.snr_db:.2f} dB: BER={p.ber:.6f} FER={p.fer:.6f} "
            f"ok={p.successful_blocks}/{p.total_blocks}")
    return SimulationResult(
        config=config,
        snr_points=snr_points,
        wall_clock_seconds=time.time() - start_time,
    )
