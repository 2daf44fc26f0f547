"""Quasi-cyclic structure detection.

Every LDPC family in the reference database (WiMAX 802.16e, WiFi 802.11n,
WiGig 802.11ad, WRAN 802.22, CCSDS, Tanner) is quasi-cyclic: H consists of
Z x Z blocks that are sums of cyclically shifted identities. The
Tanner-graph edge permutation then factorizes into per-block-edge cyclic
rolls along the lift dimension, which the CUDA decode loop executes as
indexed shared-memory reads (see ldpc_tpu_torch/csrc/decode_group.cuh).

The detector brute-forces candidate lift sizes Z (divisors of gcd(n, m), the
largest first) and verifies that every nonzero diagonal of every block is
complete. Multi-diagonal blocks (weight >= 2 circulants, e.g. CCSDS AR4JA)
are supported: each (block_row, block_col, shift) triple becomes one base
edge.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class QCLayout:
    """Quasi-cyclic factorization of a parity-check matrix.

    H[bi*Z + r, bj*Z + c] = 1  iff  (bi, bj, (c - r) % Z) is in ``edges``.
    Edge slot (bi, s) with (bj, shift) connects check (bi, r) to variable
    (bj, (r + shift) % Z) for every r in 0..Z-1.
    """

    n: int
    m: int
    Z: int
    nb: int  # base columns  (n // Z)
    mb: int  # base rows     (m // Z)
    edges: tuple[tuple[int, int, int], ...]  # (block_row, block_col, shift)

    @property
    def n_base_edges(self) -> int:
        return len(self.edges)

    @property
    def single_diagonal(self) -> bool:
        """True when every base block holds at most one circulant (weight 1).

        Multi-diagonal blocks (e.g. CCSDS '0+7') put two edges of one check
        row on the same block column, which breaks schedules that assume
        layers are conflict-free (the additive update in
        ldpc_tpu_torch.ops.decode_loop handles them)."""
        return len({(bi, bj) for bi, bj, _ in self.edges}) == len(self.edges)

    def row_slots(self) -> list[list[tuple[int, int]]]:
        """Per base row: list of (block_col, shift) in edge order."""
        rows: list[list[tuple[int, int]]] = [[] for _ in range(self.mb)]
        for bi, bj, s in self.edges:
            rows[bi].append((bj, s))
        return rows

    def col_slots(self) -> list[list[tuple[int, int, int]]]:
        """Per base col: list of (block_row, slot_in_row, shift)."""
        cols: list[list[tuple[int, int, int]]] = [[] for _ in range(self.nb)]
        counts = [0] * self.mb
        for bi, bj, s in self.edges:
            cols[bj].append((bi, counts[bi], s))
            counts[bi] += 1
        return cols

    def to_dense(self) -> np.ndarray:
        H = np.zeros((self.m, self.n), dtype=np.uint8)
        r = np.arange(self.Z)
        for bi, bj, s in self.edges:
            H[bi * self.Z + r, bj * self.Z + (r + s) % self.Z] ^= 1
        return H


def qc_orbit_canonical(support, Z: int) -> tuple[int, ...]:
    """Canonical representative of a support's QC-shift orbit.

    Simultaneously cyclically shifting every length-Z block of a codeword
    by the same s maps position p -> (p // Z) * Z + (p % Z + s) % Z and
    preserves codeword-ness; the canonical form is the lexicographically
    smallest sorted support over all Z shifts. Shared by the
    undetected-witness study (scripts/undetected_witness.py) and the IS
    depth harvest (analysis.importance.harvest_failures) so their orbit
    keys cannot diverge. ``Z <= 1`` returns the sorted support unchanged
    (non-QC codes have no lift automorphism).
    """
    sup = np.asarray(support, np.int64)
    if Z <= 1:
        return tuple(int(p) for p in np.sort(sup))
    blocks, offs = sup // Z, sup % Z
    best = None
    for s in range(Z):
        cand = tuple(int(p) for p in np.sort(blocks * Z + (offs + s) % Z))
        if best is None or cand < best:
            best = cand
    return best


def paired_layer_groups(qc: QCLayout) -> list[list[int]]:
    """Greedy pairing of base rows with disjoint base-column support.

    A layered (serial-C) sweep processes base rows one at a time; each
    layer's check update -> posterior update is a DEPENDENT op chain, which
    under-fills the VPU's 4-wide ALUs. Two layers whose base-column supports
    are disjoint neither read nor write the same posteriors, so executing
    them back-to-back is arithmetic-identical to executing them serially --
    but expressing both in one step hands the compiler two independent
    chains to interleave (ILP doubling on the serial bottleneck).

    Returns groups of 1-2 row indices covering every base row exactly once.
    Pairing is deterministic: rows are visited in a STATIC
    fewest-candidates ordering (adjacency counts computed once up front,
    not re-counted as rows are consumed, so the heuristic is approximate --
    a dynamic greedy could pair more rows on some codes; disjointness and
    determinism are what the kernel requires and both hold exactly), ties
    by index. Low-rate protographs (802.16e R1/2, WiGig R1/2: row degree ~6-7
    of 24/16 base columns) pair fully, high-rate ones (R5/6: degree ~20 of
    24) stay serial. The FLATTENED group order is a valid serial layered
    schedule with identical arithmetic (ldpc_tpu_torch.ops.decode_loop runs
    it as the sweep order).
    """
    rows = qc.row_slots()
    mb = qc.mb
    cols = [frozenset(bj for bj, _ in r) for r in rows]
    adj = {
        i: [j for j in range(mb) if j != i and not (cols[i] & cols[j])]
        for i in range(mb)
    }
    groups: list[list[int]] = []
    used: set[int] = set()
    for i in sorted(range(mb), key=lambda i: (len(adj[i]), i)):
        if i in used:
            continue
        partner = None
        for j in sorted(adj[i], key=lambda j: (len(adj[j]), j)):
            if j not in used:
                partner = j
                break
        if partner is None:
            groups.append([i])
            used.add(i)
        else:
            groups.append(sorted([i, partner]))
            used.update((i, partner))
    # deterministic presentation order: by first row index
    groups.sort(key=lambda g: g[0])
    return groups


def detect_qc(alist, min_z: int = 4, max_base_edges: int = 512) -> QCLayout | None:
    """Find the largest lift size Z for which ``alist`` is quasi-cyclic.

    Returns None when no QC structure (with Z >= min_z) exists -- such codes
    fall back to the XLA gather-based decoder.
    """
    n, m = alist.n, alist.m
    if n == 0 or m == 0:
        return None
    H = alist.to_dense()
    g = math.gcd(n, m)
    for Z in sorted((d for d in range(min_z, g + 1) if g % d == 0), reverse=True):
        nb, mb = n // Z, m // Z
        edges: list[tuple[int, int, int]] = []
        ok = True
        for bi in range(mb):
            for bj in range(nb):
                blk = H[bi * Z : (bi + 1) * Z, bj * Z : (bj + 1) * Z]
                rr, cc = np.nonzero(blk)
                if rr.size == 0:
                    continue
                diags, counts = np.unique((cc - rr) % Z, return_counts=True)
                if not (counts == Z).all() or diags.size * Z != rr.size:
                    ok = False
                    break
                edges.extend((bi, bj, int(s)) for s in diags)
            if not ok:
                break
        if ok and len(edges) <= max_base_edges:
            return QCLayout(n=n, m=m, Z=Z, nb=nb, mb=mb, edges=tuple(edges))
    return None
