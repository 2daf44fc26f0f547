"""Monte-Carlo point executor: the fused path of the JAX runner.

Counterpart of ``ldpc_tpu/sim/runner.py:63-177, 413-889, 948-1092`` for the
fused path only. Per batch of codewords:

1. random info bits (a ``torch.Generator`` seeded from (seed, point, batch));
2. the systematic encode, one matrix product (ops.encode);
3. the fused Monte-Carlo kernel (ops.mc_kernels.MCDecoder): Philox noise
   keyed from (seed, point, batch), channel LLRs, the decode (phase 1 of a
   two-phase split, emitting its LLRs) and the error counts;
4. with a split, a stable argsort on ``ok`` that compacts the unconverged
   frames to the front lanes, and the LLR kernel (ops.mc_kernels.LLRDecoder)
   re-decoding them from the emitted LLRs with the full budget;
5. the failed-frames BER rule, ``reduce_block_stats`` and ``pack_counters``.

A Python loop over batches takes the place of ``lax.scan``. Counters
accumulate on the device and the host fetches them once per point (and
every few batches under ``target_errors``). Every decode op is per codeword,
so a two-phase split gives the same counters as a single pass, and a point
run in pieces (``start_batch``) gives the same counters as one run.

Still to be ported (ROADMAP.md): the unfused path (interleavers, QAM,
shorten/puncture, the flooding schedule), the normalized-LLR metric, int8
extrinsics, alpha schedules, meshes, the SNR sweep and the CLI.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ldpc_tpu_torch.models import standards
from ldpc_tpu_torch.models.code import LDPCCode
from ldpc_tpu_torch.models.qc import paired_layer_groups
from ldpc_tpu_torch.ops.channel import ChannelParams
from ldpc_tpu_torch.ops.decode_loop import VARIANTS
from ldpc_tpu_torch.ops.encode import make_encoder_T, random_info_bits
from ldpc_tpu_torch.ops.mc_kernels import LLRDecoder, MCDecoder
from ldpc_tpu_torch.ops.metrics import (
    BlockCounters,
    BlockStats,
    pack_counters,
    reduce_block_stats,
)
from ldpc_tpu_torch.sim.config import SimOptions
from ldpc_tpu_torch.utils.db import resolve_matrix
from ldpc_tpu_torch.utils.device import resolve_device

_M64 = (1 << 64) - 1


@lru_cache(maxsize=16)
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


@dataclass
class PointStats:
    """Host-side aggregate for one SNR point."""

    blocks: int = 0
    ok_blocks: int = 0
    error_bits: int = 0
    fer_frames: int = 0
    norm_llr_sum: float = 0.0
    conv_iters_sum: int = 0
    conv_count: int = 0

    def add(self, c: BlockCounters) -> None:
        self.blocks += int(c.blocks)
        self.ok_blocks += int(c.ok_blocks)
        self.error_bits += int(c.error_bits)
        self.fer_frames += int(c.fer_frames)
        self.norm_llr_sum += float(c.norm_llr_sum)
        self.conv_iters_sum += int(c.conv_iters_sum)
        self.conv_count += int(c.conv_count)


class PointExecutor:
    """The fused Monte-Carlo step of one (code, iterations, modulation,
    decoder) configuration, reusable across SNR points.

    ``device=None`` means the card (and raises without CUDA); the tests pass
    ``device="cpu"``, which runs the kernels' plain versions."""

    def __init__(self, code: LDPCCode, opts: SimOptions, *,
                 max_iterations: int | None = None,
                 modulation: int | None = None,
                 device: str | torch.device | None = None):
        opts = opts.resolved()
        self.device = resolve_device(device)
        self.code = code
        self.opts = opts
        self.graph = opts.decode_graph
        self.max_iterations = max_iterations or opts.iterations
        self.modulation = modulation or opts.modulation
        self.batch = opts.auto_batch(code.n)
        schedule = opts.schedule or "flooding"
        variant = opts.decoder_variant
        missing = [
            what for what, bad in (
                ("a quasi-cyclic code", code.qc is None),
                ("check_rule='exact'", opts.check_rule != "exact"),
                ("decode_graph='orig'", self.graph not in ("orig", "original")),
                ("an SPA/min-sum decoder", variant not in VARIANTS),
                ("no interleaver", opts.interleaver != "none"),
                ("modulation 1 or 2", self.modulation not in (1, 2)),
                ("channel mode 1-3", opts.mode not in (1, 2, 3)),
                ("no shorten/puncture", bool(opts.shorten or opts.puncture)),
                ("fused != 'off'", opts.fused == "off"),
                ("schedule='layered'", schedule != "layered"),
            ) if bad
        ]
        if missing:
            raise NotImplementedError(
                "the port runs the fused layered path only so far "
                "(ROADMAP.md lists the rest); this configuration needs "
                + ", ".join(missing)
            )
        if opts.normalized_llr:
            raise NotImplementedError(
                "--normalized-llr is not ported yet (ROADMAP.md)")
        if opts.msg_store != "f32":
            raise NotImplementedError(
                "--msg-store int8 is not ported yet (ROADMAP.md)")
        if opts.encoding_method not in ("standard", "STANDARD"):
            raise NotImplementedError(
                "the Richardson-Urbanke encoder is not ported yet (ROADMAP.md)")

        spec = code.encode_spec(opts.encoding_method, opts.ru_gap)
        info_pos = spec.info_pos(self.graph)
        self._encode_T = make_encoder_T(spec, self.graph, self.device)
        layer_groups = resolve_layer_groups(code.qc, opts, schedule)
        self.phase1 = resolve_two_phase(opts.two_phase, self.max_iterations,
                                        opts.check_every)
        loop_kw = dict(alpha=opts.minsum_alpha, beta=opts.minsum_beta,
                       schedule=schedule, layer_groups=layer_groups,
                       check_every=opts.check_every)
        mc_kw = dict(mode=opts.mode, modulation=self.modulation, **loop_kw)
        self._mc_full = MCDecoder(code.qc, info_pos, self.max_iterations,
                                  variant, **mc_kw)
        self.lanes = self._mc_full.lanes
        if self.phase1:
            self._mc1 = MCDecoder(code.qc, info_pos, self.phase1, variant,
                                  emit_llr=True, **mc_kw)
            self._llr_dec = LLRDecoder(code.qc, info_pos, self.max_iterations,
                                       variant, **loop_kw)
        self._kernel_base = ("cuda" if self.device.type == "cuda" else "cpu") \
            + "+fused+layered" \
            + ("+paired" if layer_groups is not None else "") \
            + (f"+ce{opts.check_every}" if opts.check_every > 1 else "")
        self._consts_cache: dict[float, torch.Tensor] = {}
        self.total_iters_run = 0
        self.last_probe: dict = {}
        self._auto = bool(self.phase1) and opts.two_phase == "auto"
        self._two_phase_choice: dict[float, bool] = {}
        self._overhead_us = None
        if self._auto:
            self.kernel_used = self._kernel_base + "+2phase(auto)"
            if self.device.type == "cuda":
                self._overhead_us = self._measure_overhead()
        else:
            self.kernel_used = self._kernel_base + (
                f"+2phase({self.phase1})" if self.phase1 else "")

    # ------------------------------------------------------------ batches --

    def _words(self, key: int):
        """(generator of the info bits, Philox key words) of one batch."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_mix(key ^ 1) >> 1)
        k = _mix(key ^ 2)
        return gen, (k & 0xFFFFFFFF, k >> 32)

    def _decode(self, wT, consts, seeds, raw, p1: int):
        """Per-codeword (err, ok, conv, norm, iters) of one batch at phase-1
        split ``p1`` (0 = single pass)."""
        if not p1:
            return self._mc_full(wT, consts, seeds=seeds, raw=raw)
        err1, ok1, conv1, norm1, it1, llrT = self._mc1(wT, consts, seeds=seeds,
                                                       raw=raw)
        # compact unconverged frames to the front lanes: keys 0 before 1
        order = torch.argsort(ok1.to(torch.int32), stable=True)
        llr_s = llrT.index_select(1, order)
        w_s = wT.index_select(1, order)
        done0 = ok1.index_select(0, order).to(torch.float32)
        err2, ok2, conv2, norm2, it2 = self._llr_dec(llr_s, w_s, done0)

        def unsort(x):
            return torch.empty_like(x).index_copy_(0, order, x)

        err = torch.where(ok1, err1, unsort(err2))
        conv = torch.where(ok1, conv1, unsort(conv2))
        norm = torch.where(ok1, norm1, unsort(norm2))
        ok = ok1 | unsort(ok2)
        # the trips of the two phases add (a re-decoded frame's block ran it1
        # then it2 trips; a converged frame may inherit its phase-2 block's)
        iters = it1 + unsort(it2)
        return err, ok, conv, norm, iters

    def step(self, key: int, consts: torch.Tensor, p1: int, *,
             u: torch.Tensor | None = None, raw: torch.Tensor | None = None):
        """One batch: ``(BlockStats, per-codeword iters)``.

        ``u`` (uint8 [batch, k]) and ``raw`` (words in the injected layout)
        replace the batch's drawn info bits and noise, for tests that feed
        both packages the same inputs."""
        gen, seeds = self._words(key)
        if u is None:
            u = random_info_bits(gen, self.batch, self.code.k)
        wT = self._encode_T(u)
        err, ok, conv, norm, iters = self._decode(wT, consts, seeds, raw, p1)
        if not self.opts.exact_ber:
            # reference: bits counted only when decode failed (main.py:134)
            err = torch.where(ok, 0, err).to(torch.int32)
        return BlockStats(error_bits=err, ok=ok, conv_iter=conv,
                          norm_llr=norm), iters

    def packed(self, stats: BlockStats, iters: torch.Tensor,
               take: int) -> torch.Tensor:
        """int32[8] counters of the first ``take`` codewords of a batch."""
        valid = torch.arange(self.batch, device=self.device) < take
        return pack_counters(reduce_block_stats(stats, valid), iters.max())

    # ----------------------------------------------------------- two-phase --

    def _measure_overhead(self) -> float:
        """Device time (us) of what a split adds per batch: the sort, the
        gathers, the scatters back and one LLR-kernel launch on a batch that
        is all done. Measured once per executor (warm, best of three).

        One discarded single-pass batch runs first, so that one-time costs
        (library handles, kernel loading) fall neither here nor on the
        probe that prices a block trip."""
        n, B = self.code.n, self.batch
        dev = self.device
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

    def _probe(self, key: int, consts: torch.Tensor):
        """One single-pass batch whose convergence picks the dispatch mode;
        on the card its kernel time prices a block trip."""
        cuda = self.device.type == "cuda"
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        stats, iters = self.step(key, consts, 0)
        trip_us = None
        if cuda:
            t1.record()
            t1.synchronize()
            batch_us = t0.elapsed_time(t1) * 1e3
        conv = stats.conv_iter.cpu().numpy()
        okv = stats.ok.cpu().numpy()
        if cuda:
            m = two_phase_trip_model(conv, okv, self.phase1,
                                     self.max_iterations, lanes=self.lanes)
            trip_us = batch_us / max(m["single"], 1e-9)
        return stats, iters, self._decide_two_phase(conv, okv, trip_us)

    def run_point(self, snr_db: float, blocks: int, base_key: int | None = None,
                  point_index: int = 0, *, start_batch: int = 0) -> PointStats:
        """Stream Monte-Carlo batches for one SNR point.

        Batch ``i`` of the point draws from ``derive_key(point key, i)``, so
        ``run_point(s, a + b)`` equals ``run_point(s, a)`` followed by
        ``run_point(s, b, start_batch=a // batch)`` when ``a`` is a whole
        number of batches."""
        consts = self.consts(snr_db)
        key_point = derive_key(self.opts.seed if base_key is None else base_key,
                               point_index)
        B = self.batch
        acc = torch.zeros(8, dtype=torch.float64, device=self.device)
        stats = PointStats()
        remaining = blocks
        batch_idx = start_batch
        target = self.opts.target_errors

        def add(packed):
            acc[:7] += packed[:7].to(torch.float64)
            acc[7] += packed[7:8].view(torch.float32)[0].to(torch.float64)

        def flush():
            v = acc.tolist()  # the one host fetch
            acc.zero_()
            stats.add(BlockCounters(*(int(x) for x in v[:4]), float(v[7]),
                                    int(v[4]), int(v[5])))
            self.total_iters_run += int(v[6])

        p1 = self.phase1
        if self._auto and remaining > 0:
            use2 = self._two_phase_choice.get(snr_db)
            if use2 is None:
                take = min(remaining, B)
                s, it, use2 = self._probe(derive_key(key_point, batch_idx), consts)
                add(self.packed(s, it, take))
                remaining -= take
                batch_idx += 1
                self._two_phase_choice[snr_db] = use2
            self.kernel_used = self._kernel_base + (
                f"+2phase(auto:{self.phase1})" if use2 else "+2phase(auto:off)")
            p1 = self.phase1 if use2 else 0
        since_flush = 0
        while remaining > 0:
            take = min(remaining, B)
            s, it = self.step(derive_key(key_point, batch_idx), consts, p1)
            add(self.packed(s, it, take))
            remaining -= take
            batch_idx += 1
            since_flush += 1
            if target and since_flush >= 8:
                # sequential MC early stop needs the frame-error count
                flush()
                since_flush = 0
                if stats.fer_frames >= target:
                    break
        flush()
        return stats
