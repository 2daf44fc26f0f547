"""Plain PyTorch version of the QC decode loop.

Counterpart of ``ldpc_tpu/ops/spa_pallas.py:59-574`` (``make_check_update``,
``resolve_alpha_schedule``, the int8 message grid and ``make_decode_loop``,
the body shared by the fused Monte-Carlo kernels and the standalone QC
decoder). It repeats the CUDA decode loop's arithmetic
in the same op order (csrc/decode_group.cuh, ``decode_group``) on ``[n, B]``
tensors, rows ``bj * Z + z``, codewords on the
minor axis. The CPU tests hold it against the JAX package; on the card
``chip_smoke.py`` holds the kernels against it. Nothing on the main path
calls it when a card is present.

What it covers, as the kernels do: the layered (serial-C) schedule over base
rows in the flattened order of ``layer_groups``, with overwrite updates for
single-diagonal layers and the additive update ``L += roll(E_new - E_old)``
for multi-diagonal ones (CCSDS); the flooding schedule (every check row from
``roll(L) - E``, then every posterior ``llr + sum roll(E, -s)`` in column-slot
order); SPA and the min-sum family; normalized min-sum with a scalar alpha
or a per-sweep schedule, ``alpha[min(it, T-1)]`` ([T]) or per row degree
class ([T, D], :func:`resolve_alpha_schedule`); the extrinsics E stored as
f32 or, for the min-sum family, as int8 on a 255-level grid over [-24, 24]
(:func:`e_quantize`, with L kept consistent with the stored value); a
syndrome check every ``check_every`` sweeps with the window's ``active`` set
fixed; a per-lane pre-done mask; the normalized-LLR flip metric
(``track_norm``).

Every op is per lane, so a lane's trajectory does not depend on the others.
Only ``iters`` does: the kernel reports to each lane the trip count of its
block of ``lanes`` codewords, the largest of their trips (each codeword runs
until it passes a check or the budget ends; :func:`block_max_trips`); this
version reports the same per-block trips. ``lanes`` also models the JAX
package's tiles (``sim.runner.two_phase_trip_model``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ldpc_tpu_torch.models.qc import QCLayout
from ldpc_tpu_torch.ops.spa import (
    LLR_WINDOW,
    PROD_CLIP_F32,
    TANH_IN_CLIP,
    exclusive_combine,
)

VARIANTS = ("spa", "minsum", "normalized_minsum", "offset_minsum")
MIN_SUM = ("minsum", "normalized_minsum", "offset_minsum")

# int8 extrinsic grid for msg_store='int8' (``spa_pallas.py:107-112``):
# uniform levels q * E_INT8_SCALE, q in [-127, 127], over [-24, 24]. The f32
# constants are rounded once from float64, as the JAX kernels' Python floats
# are (csrc/decode_group.cuh holds the same two values).
E_INT8_CLIP = 24.0
E_INT8_SCALE = E_INT8_CLIP / 127.0
E_SCALE_F32 = float(np.float32(E_INT8_SCALE))
E_INV_F32 = float(np.float32(1.0 / E_INT8_SCALE))
MSG_STORES = ("f32", "int8")


def e_quantize(val: torch.Tensor) -> torch.Tensor:
    """f32 -> the f32 value the int8 store reproduces (``E_quantize``):
    clip to +-24, scale, round half to even, scale back."""
    q = torch.round(torch.clamp(val, -E_INT8_CLIP, E_INT8_CLIP) * E_INV_F32)
    return q * E_SCALE_F32


def e_write(val: torch.Tensor) -> torch.Tensor:
    """An :func:`e_quantize`'d value as its int8 level (``E_write``)."""
    return torch.round(val * E_INV_F32).to(torch.int8)


def e_read(q: torch.Tensor) -> torch.Tensor:
    """int8 levels -> f32 values (``E_read``)."""
    return q.to(torch.float32) * E_SCALE_F32


def resolve_alpha_schedule(alpha, variant: str, row_degrees):
    """Validate a per-sweep alpha schedule against the QC graph
    (``spa_pallas.resolve_alpha_schedule``): ``(arr, class_of)``, ``arr``
    the float64 schedule ([T] or [T, D]) or None for a scalar, and
    ``class_of[bi]`` base row ``bi``'s column of a [T, D] schedule (the
    distinct row degrees ascending), else None."""
    if np.ndim(alpha) == 0:
        return None, None
    if variant != "normalized_minsum":
        raise ValueError(
            "per-iteration alpha requires variant='normalized_minsum'")
    arr = np.asarray(alpha, np.float64)
    if arr.size == 0:
        raise ValueError(
            "alpha schedule is empty: need at least one per-iteration value")
    if arr.ndim == 1:
        return arr, None
    if arr.ndim != 2:
        raise ValueError("alpha schedule must be scalar, [T] or [T, D]")
    degrees = sorted({int(d) for d in row_degrees})
    if arr.shape[1] != len(degrees):
        raise ValueError(
            f"alpha has {arr.shape[1]} degree classes but the graph has "
            f"{len(degrees)} distinct check degrees {degrees}")
    lookup = {d: i for i, d in enumerate(degrees)}
    return arr, [lookup[int(d)] for d in row_degrees]


def check_msg_store(msg_store: str, variant: str) -> None:
    """The JAX kernels' refusals of ``msg_store`` (``spa_pallas.py:346-353``)."""
    if msg_store not in MSG_STORES:
        raise ValueError(f"msg_store must be 'f32' or 'int8': {msg_store!r}")
    if msg_store == "int8" and variant == "spa":
        raise ValueError(
            "msg_store='int8' requires a min-sum variant: the SPA tanh rule "
            "loses FER under message quantization (examples/quantized_messages)")


def normalize_variant(variant: str) -> str:
    v = variant.lower().replace("-", "_")
    if v not in VARIANTS:
        raise ValueError(f"decode loop does not support variant {variant!r}")
    return v


@dataclass(frozen=True)
class QCTables:
    """Static schedule of one QC code: flattened edge slots and layer groups.

    ``row_off[bi]`` is the first flattened E slot of base row ``bi``;
    ``slot_col`` / ``slot_shift`` give the (base column, shift) of each slot;
    ``groups`` are the layer steps in schedule order (1 or ``R`` rows each);
    ``row_dup[bi]`` marks a multi-diagonal row (one base column twice).
    """

    qc: QCLayout
    groups: tuple[tuple[int, ...], ...]
    row_off: np.ndarray  # int32 [mb + 1]
    slot_col: np.ndarray  # int32 [e_slots]
    slot_shift: np.ndarray  # int32 [e_slots]
    row_dup: np.ndarray  # int32 [mb]

    @property
    def e_slots(self) -> int:
        return int(self.row_off[-1])

    @property
    def R(self) -> int:
        """Rows per layer step (1, or 2 for paired groups)."""
        return max(len(g) for g in self.groups)

    @property
    def degrees(self) -> np.ndarray:
        """Row degree of each base row."""
        return np.diff(self.row_off)

    @property
    def dmax(self) -> int:
        return int(np.diff(self.row_off).max())

    @property
    def has_dup(self) -> bool:
        return bool(self.row_dup.any())

    @property
    def order(self) -> list[int]:
        return [bi for g in self.groups for bi in g]

    def column_slots(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Flooding's posterior tables: ``col_off`` [nb + 1] (first entry of
        each base column), ``col_slot`` / ``col_shift`` [e_slots] (flattened
        E slot and shift of each entry), in ``qc.col_slots()`` (edge) order,
        the order the posterior sum runs in."""
        qc = self.qc
        col_off = np.zeros(qc.nb + 1, np.int32)
        col_slot, col_shift = [], []
        for bj, entries in enumerate(qc.col_slots()):
            col_off[bj + 1] = col_off[bj] + len(entries)
            for bi, slot, s in entries:
                col_slot.append(int(self.row_off[bi]) + slot)
                col_shift.append(s % qc.Z)
        return (col_off, np.asarray(col_slot, np.int32),
                np.asarray(col_shift, np.int32))


def build_tables(qc: QCLayout, layer_groups=None) -> QCTables:
    """Validate ``layer_groups`` as ``make_decode_loop`` does and flatten the
    QC graph into the slot tables both decode-loop versions read."""
    row_slots = qc.row_slots()
    mb = qc.mb
    if layer_groups is None:
        groups = [[bi] for bi in range(mb)]
    else:
        flat = sorted(bi for g in layer_groups for bi in g)
        if flat != list(range(mb)):
            raise ValueError(
                f"layer_groups must partition base rows 0..{mb - 1}: "
                f"{layer_groups!r}"
            )
        for g in layer_groups:
            if len(g) > 2:
                raise ValueError(f"layer groups hold 1 or 2 rows: {g!r}")
            if len(g) == 2:
                a = {bj for bj, _ in row_slots[g[0]]}
                b = {bj for bj, _ in row_slots[g[1]]}
                if a & b:
                    raise ValueError(
                        f"layer group {g} rows share base columns "
                        f"{sorted(a & b)} -- grouped rows must be disjoint"
                    )
        groups = [list(g) for g in layer_groups]
    row_off = np.zeros(mb + 1, np.int32)
    for bi, r in enumerate(row_slots):
        row_off[bi + 1] = row_off[bi] + len(r)
    slots = [s for r in row_slots for s in r]
    slot_col = np.asarray([bj for bj, _ in slots], np.int32)
    slot_shift = np.asarray([s % qc.Z for _, s in slots], np.int32)
    row_dup = np.asarray(
        [len({bj for bj, _ in r}) < len(r) for r in row_slots], np.int32
    )
    return QCTables(qc=qc, groups=tuple(tuple(g) for g in groups),
                    row_off=row_off, slot_col=slot_col,
                    slot_shift=slot_shift, row_dup=row_dup)


def block_max_trips(ok, conv, lanes: int, max_it: int, live=None):
    """Per frame: the largest trip count among the frames of its block of
    ``lanes`` (a frame's trips: conv + 1 when it converged, else the
    budget; 0 where ``live`` is given and False: a pre-done frame)."""
    trips = torch.where(ok, conv.to(torch.int64) + 1, max_it)
    if live is not None:
        trips = torch.where(live, trips, 0)
    B = trips.numel()
    nb = -(-B // lanes)
    pad = torch.zeros(nb * lanes - B, dtype=trips.dtype, device=trips.device)
    blk = torch.cat([trips, pad]).view(nb, lanes).amax(dim=1)
    return blk.repeat_interleave(lanes)[:B]


def check_update(msgs: torch.Tensor, variant: str, alpha: float,
                 beta: float) -> torch.Tensor:
    """Leave-one-out check update of one row: ``msgs`` [d, ...] -> [d, ...].

    The elementwise steps run on the stacked slots at once (elementwise ops
    do not depend on batching); the products and minima fold slot by slot in
    :func:`exclusive_combine` order, as the kernel does."""
    if variant == "spa":
        t = torch.clamp(
            torch.tanh(torch.clamp(msgs * 0.5, -TANH_IN_CLIP, TANH_IN_CLIP)),
            -PROD_CLIP_F32, PROD_CLIP_F32,
        )
        excl = exclusive_combine(list(t.unbind(0)), torch.mul)
        p = torch.stack([torch.ones_like(msgs[0]) if e is None else e
                         for e in excl])
        p = torch.clamp(p, -PROD_CLIP_F32, PROD_CLIP_F32)
        return torch.log((1.0 + p) / (1.0 - p))
    sgn = torch.where(msgs < 0, -1.0, 1.0).to(torch.float32)
    mag = torch.abs(msgs)
    excl_sgn = exclusive_combine(list(sgn.unbind(0)), torch.mul)
    excl_mag = exclusive_combine(list(mag.unbind(0)), torch.minimum)
    sg = torch.stack([torch.ones_like(msgs[0]) if e is None else e
                      for e in excl_sgn])
    mg = torch.stack([torch.full_like(msgs[0], 1e30) if e is None else e
                      for e in excl_mag])
    if variant == "normalized_minsum":
        mg = alpha * mg
    elif variant == "offset_minsum":
        mg = torch.clamp_min(mg - beta, 0.0)
    return sg * mg


class DecodeLoop:
    """The plain decode loop of one code on one device.

    ``decode(L, done0)`` decodes in place: ``L`` f32 [n, B] holds the channel
    LLRs in the log(p0/p1) domain on entry and the final posteriors (frozen
    at each lane's convergence) on exit. Returns ``(done, conv, iters,
    norm)``: bool / int32 / int32 / f32 [B]; ``norm`` is zeros unless
    ``track_norm`` (then ``info_pos`` names the info positions the flip
    metric counts). ``run`` returns the first three. ``alpha`` is a scalar or
    a schedule (:func:`resolve_alpha_schedule`); ``msg_store='int8'`` keeps
    E as int8 levels (:func:`e_quantize`).
    """

    def __init__(self, tables: QCTables, max_iterations: int, variant: str,
                 *, alpha=0.75, beta: float = 0.15,
                 check_every: int = 1, lanes: int = 128,
                 device: str | torch.device = "cpu",
                 schedule: str = "layered", track_norm: bool = False,
                 info_pos=None, msg_store: str = "f32"):
        if check_every < 1 or max_iterations % check_every:
            raise ValueError(
                f"check_every={check_every} must divide "
                f"max_iterations={max_iterations}"
            )
        if schedule not in ("layered", "flooding"):
            raise ValueError(f"Unknown schedule: {schedule!r}")
        if track_norm and check_every > 1:
            raise ValueError(
                "check_every > 1 requires track_norm=False: the "
                "normalized-LLR flip metric is defined per iteration"
            )
        if track_norm and info_pos is None:
            raise ValueError("track_norm needs the info positions")
        self.tables = tables
        self.max_iterations = int(max_iterations)
        self.variant = normalize_variant(variant)
        check_msg_store(msg_store, self.variant)
        self.int8 = msg_store == "int8"
        arr, cls = resolve_alpha_schedule(alpha, self.variant, tables.degrees)
        # each schedule value cast to f32 once, as _sched_at's
        # jnp.float32(vec[t]) does; a [T] schedule is one degree class
        self._sched = None if arr is None else \
            np.asarray(arr, np.float32).reshape(arr.shape[0], -1)
        self._cls = cls
        self.alpha = float(alpha) if arr is None else None
        self.beta = float(beta)
        self.check_every = int(check_every)
        self.lanes = int(lanes)
        self.flooding = schedule == "flooding"
        self.track_norm = bool(track_norm)
        qc = tables.qc
        Z = qc.Z
        z = np.arange(Z)

        def as_long(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=device)

        # per row: L rows read by its slots (bj * Z + (z + s) % Z), slot-major
        self._rows = []
        for bi in range(qc.mb):
            lo, hi = int(tables.row_off[bi]), int(tables.row_off[bi + 1])
            idx = np.concatenate([
                tables.slot_col[j] * Z + (z + tables.slot_shift[j]) % Z
                for j in range(lo, hi)
            ]) if hi > lo else np.zeros(0, np.int64)
            self._rows.append((lo, hi, bool(tables.row_dup[bi]), as_long(idx)))
        # syndrome: every edge's variable row and check row
        var_idx = np.concatenate([r[3].cpu().numpy() for r in self._rows])
        chk_idx = np.concatenate([
            bi * Z + np.tile(z, int(tables.row_off[bi + 1] - tables.row_off[bi]))
            for bi in range(qc.mb)
        ])
        self._var_idx = as_long(var_idx)
        self._chk_idx = as_long(chk_idx)
        if self.flooding:
            self._flood_tables(as_long)
        if track_norm:
            info = np.asarray(info_pos, np.int64)
            self._info = as_long(info)
            self._k = torch.tensor(float(max(info.size, 1)),
                                   dtype=torch.float32, device=device)

    def alpha_at(self, it: int, bi: int) -> float:
        """The normalized min-sum scale of base row ``bi`` at sweep ``it``:
        the scalar, or ``alpha[min(it, T-1)]`` of the row's degree class."""
        if self._sched is None:
            return self.alpha
        t = min(it, self._sched.shape[0] - 1)
        return float(self._sched[t, 0 if self._cls is None else self._cls[bi]])

    def _e_read(self, e: torch.Tensor) -> torch.Tensor:
        return e_read(e) if self.int8 else e

    def _e_new(self, e: torch.Tensor) -> torch.Tensor:
        return e_quantize(e) if self.int8 else e

    def _e_store(self, e: torch.Tensor) -> torch.Tensor:
        return e_write(e) if self.int8 else e

    def _flood_tables(self, as_long) -> None:
        """Gather indices of the flooding sweep, grouped by degree so that
        each phase is a few tensor ops: per row degree d, the rows' L reads
        and E slots [rows, d, Z]; per column degree, the columns' E reads
        (flattened ``slot * Z + (z - s) % Z``) [cols, d, Z]."""
        t = self.tables
        qc = t.qc
        Z = qc.Z
        z = np.arange(Z)
        by_deg: dict[int, list[int]] = {}
        for bi in range(qc.mb):
            by_deg.setdefault(int(t.row_off[bi + 1] - t.row_off[bi]), []).append(bi)
        self._flood_rows = []
        for d, rows in sorted(by_deg.items()):
            if d == 0:
                continue
            slots = np.asarray([[int(t.row_off[bi]) + j for j in range(d)]
                                for bi in rows])  # [nr, d]
            lidx = (t.slot_col[slots][..., None] * Z
                    + (z + t.slot_shift[slots][..., None]) % Z)  # [nr, d, Z]
            self._flood_rows.append((d, len(rows), as_long(slots.ravel()),
                                     as_long(lidx.ravel()), rows[0]))
        col_off, col_slot, col_shift = t.column_slots()
        by_deg = {}
        for bj in range(qc.nb):
            by_deg.setdefault(int(col_off[bj + 1] - col_off[bj]), []).append(bj)
        self._flood_cols = []
        for d, cols in sorted(by_deg.items()):
            ent = np.asarray([[int(col_off[bj]) + j for j in range(d)]
                              for bj in cols], np.int64).reshape(len(cols), d)
            eidx = (col_slot[ent][..., None] * Z
                    + (z - col_shift[ent][..., None]) % Z)  # [nc, d, Z]
            self._flood_cols.append((d, as_long(cols), as_long(eidx.ravel())))

    def sweep(self, L: torch.Tensor, E: torch.Tensor, active: torch.Tensor,
              it: int = 0) -> None:
        """Layered sweep ``it`` in schedule order, in place on L and E: each
        row's messages ``roll(L) - E_read``, its extrinsics quantized on the
        way out (int8), the posteriors from the quantized values."""
        qc = self.tables.qc
        Z = qc.Z
        B = L.shape[1]
        for bi in self.tables.order:
            lo, hi, dup, idx = self._rows[bi]
            d = hi - lo
            if d == 0:
                continue
            old = L.index_select(0, idx)  # [d*Z, B]
            e_stored = E[lo:hi]  # [d, Z, B]
            e_old = self._e_read(e_stored)
            msgs = old.view(d, Z, B) - e_old
            e_new = self._e_new(check_update(msgs, self.variant,
                                             self.alpha_at(it, bi), self.beta))
            if dup:
                # multi-diagonal row: extrinsic deltas accumulate per base
                # column in slot order, then add to the posterior
                deltas: dict[int, torch.Tensor] = {}
                for j in range(d):
                    bj = int(self.tables.slot_col[lo + j])
                    s = int(self.tables.slot_shift[lo + j])
                    dj = torch.roll(e_new[j] - e_old[j], shifts=s, dims=0)
                    deltas[bj] = dj if bj not in deltas else deltas[bj] + dj
                for bj, acc in deltas.items():
                    blk = L[bj * Z:(bj + 1) * Z]
                    L[bj * Z:(bj + 1) * Z] = torch.where(active, blk + acc, blk)
            else:
                l_new = (msgs + e_new).view(d * Z, B)
                L.index_copy_(0, idx, torch.where(active, l_new, old))
            E[lo:hi] = torch.where(active, self._e_store(e_new), e_stored)

    def flood_sweep(self, L: torch.Tensor, E: torch.Tensor, llr: torch.Tensor,
                    active: torch.Tensor, it: int = 0) -> None:
        """Flooding sweep ``it``, in place on L and E: every check row from
        ``roll(L) - E_read`` (E written where active, quantized under int8),
        then every posterior ``llr + roll(E_read[slot], -s)`` summed in
        column-slot order (L written where active, as the kernel does)."""
        qc = self.tables.qc
        Z = qc.Z
        B = L.shape[1]
        for d, nr, slots, lidx, bi0 in self._flood_rows:
            e_stored = E.index_select(0, slots).view(nr, d, Z, B)
            msgs = L.index_select(0, lidx).view(nr, d, Z, B) \
                - self._e_read(e_stored)
            # rows of one degree share a degree class, so one alpha
            e_new = check_update(msgs.transpose(0, 1), self.variant,
                                 self.alpha_at(it, bi0),
                                 self.beta).transpose(0, 1)
            e_new = self._e_store(self._e_new(e_new))
            E.index_copy_(0, slots, torch.where(active, e_new, e_stored)
                          .reshape(nr * d, Z, B))
        Ef = self._e_read(E).view(-1, B)
        L3 = L.view(qc.nb, Z, B)
        for d, cols, eidx in self._flood_cols:
            g = Ef.index_select(0, eidx).view(len(cols), d, Z, B)
            acc = llr.view(qc.nb, Z, B).index_select(0, cols)
            for j in range(d):
                acc = acc + g[:, j]
            L3.index_copy_(0, cols, torch.where(active, acc,
                                                L3.index_select(0, cols)))

    def unsatisfied(self, L: torch.Tensor) -> torch.Tensor:
        """bool [B]: some check of the lane fails (bit = L < 0)."""
        qc = self.tables.qc
        bits = (L.index_select(0, self._var_idx) < 0).to(torch.int32)
        par = torch.zeros((qc.mb * qc.Z, L.shape[1]), dtype=torch.int32,
                          device=L.device)
        par.index_add_(0, self._chk_idx, bits)
        return ((par & 1) != 0).any(dim=0)

    def decode(self, L: torch.Tensor, done0: torch.Tensor):
        qc = self.tables.qc
        n, B = L.shape
        if n != qc.n:
            raise ValueError(f"L has {n} rows, the code has n={qc.n}")
        dev = L.device
        E = torch.zeros((self.tables.e_slots, qc.Z, B),
                        dtype=torch.int8 if self.int8 else torch.float32,
                        device=dev)
        llr = L.clone() if self.flooding else None
        done = done0.to(torch.bool).clone()
        conv = torch.full((B,), -1, dtype=torch.int32, device=dev)
        norm = torch.zeros(B, dtype=torch.float32, device=dev)
        prior = L.index_select(0, self._info) if self.track_norm else None
        ce = self.check_every
        it = 0
        while it < self.max_iterations and not bool(done.all()):
            active = ~done
            for step in range(ce):
                if self.flooding:
                    self.flood_sweep(L, E, llr, active, it + step)
                else:
                    self.sweep(L, E, active, it + step)
            ok_now = ~self.unsatisfied(L)
            if self.track_norm:
                # integer flip count over the info bits, divided once in f32
                Li = L.index_select(0, self._info)
                flips = ((Li.abs() <= LLR_WINDOW) & (prior * Li < 0)).sum(dim=0)
                norm = torch.where(active, flips.to(torch.float32) / self._k,
                                   norm)
                prior = Li
            conv = torch.where(active & ok_now,
                               torch.full_like(conv, it + ce - 1), conv)
            done = done | ok_now
            it += ce
        # a lane's trips: its check iteration + 1, or the budget; its
        # block's: the largest among the lanes that ran
        iters = block_max_trips(done, conv, self.lanes, self.max_iterations,
                                live=~done0.to(torch.bool))
        return done, conv, iters.to(torch.int32), norm

    def run(self, L: torch.Tensor, done0: torch.Tensor):
        done, conv, iters, _ = self.decode(L, done0)
        return done, conv, iters
