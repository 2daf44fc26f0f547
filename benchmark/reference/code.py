"""A quasi-cyclic LDPC code, its systematic GF(2) encoder and its layer
order. Each code family builds one from its standard's base matrix in
``benchmark/reference/codes/<family>.py``. Nothing here is read from the
program under test.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np


@dataclass(frozen=True)
class QCCode:
    """A quasi-cyclic code: ``edges`` (base row, base column, shift) in
    row-major order; check (bi, r) meets variable (bj, (r + shift) % Z)."""

    n: int
    m: int
    Z: int
    nb: int
    mb: int
    edges: tuple[tuple[int, int, int], ...]

    def row_slots(self) -> list[list[tuple[int, int]]]:
        rows: list[list[tuple[int, int]]] = [[] for _ in range(self.mb)]
        for bi, bj, s in self.edges:
            rows[bi].append((bj, s))
        return rows

    def col_slots(self) -> list[list[tuple[int, int, int]]]:
        cols: list[list[tuple[int, int, int]]] = [[] for _ in range(self.nb)]
        slot = [0] * self.mb
        for bi, bj, s in self.edges:
            cols[bj].append((bi, slot[bi], s))
            slot[bi] += 1
        return cols

    def dense(self) -> np.ndarray:
        H = np.zeros((self.m, self.n), dtype=np.uint8)
        r = np.arange(self.Z)
        for bi, bj, s in self.edges:
            H[bi * self.Z + r, bj * self.Z + (r + s) % self.Z] ^= 1
        return H

    @cached_property
    def systematic(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(info_pos, pivots, A)``: Gauss-Jordan over GF(2), columns left
        to right; info bit t sits at the t-th column that is no pivot, and
        the bit at ``pivots[r]`` is ``A[r] . u`` mod 2."""
        M = self.dense().astype(bool)
        pivots, row = [], 0
        for col in range(self.n):
            if row == M.shape[0]:
                break
            hits = np.nonzero(M[row:, col])[0]
            if hits.size == 0:
                continue
            p = row + int(hits[0])
            M[[row, p]] = M[[p, row]]
            others = M[:, col].copy()
            others[row] = False
            M[others] ^= M[row]
            pivots.append(col)
            row += 1
        M = M[:row]
        info = np.setdiff1d(np.arange(self.n), pivots)
        return info, np.asarray(pivots), M[:, info].astype(np.float32)

    @property
    def k(self) -> int:
        return self.n - len(self.systematic[1])

    def generator(self) -> np.ndarray:
        """f32 [k, n]: codeword = u @ G mod 2."""
        info, pivots, A = self.systematic
        G = np.zeros((info.size, self.n), np.float32)
        G[np.arange(info.size), info] = 1.0
        G[:, pivots] = A.T
        return G

    def paired_order(self) -> list[int]:
        """The layer order of the paired schedule: rows are visited by their
        count of row-disjoint partners (then index); each takes the free
        partner with the fewest partners (then index); pairs are listed by
        their first row, each pair low row first."""
        cols = [{bj for bj, _ in r} for r in self.row_slots()]
        adj = {i: [j for j in range(self.mb) if j != i and not cols[i] & cols[j]]
               for i in range(self.mb)}
        used, groups = set(), []
        for i in sorted(range(self.mb), key=lambda i: (len(adj[i]), i)):
            if i in used:
                continue
            free = [j for j in sorted(adj[i], key=lambda j: (len(adj[j]), j))
                    if j not in used]
            g = sorted([i, free[0]]) if free else [i]
            used.update(g)
            groups.append(g)
        groups.sort(key=lambda g: g[0])
        return [bi for g in groups for bi in g]



def from_blocks(blocks: list[list[tuple[int, ...]]], Z: int) -> QCCode:
    """The code whose base block (bi, bj) is the sum of the Z x Z circulants
    of the shifts ``blocks[bi][bj]`` (none: the zero block), one slot each,
    in the order given."""
    edges = tuple((bi, bj, s) for bi, row in enumerate(blocks)
                  for bj, shifts in enumerate(row) for s in shifts)
    mb, nb = len(blocks), len(blocks[0])
    return QCCode(n=nb * Z, m=mb * Z, Z=Z, nb=nb, mb=mb, edges=edges)
