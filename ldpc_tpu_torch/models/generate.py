"""Synthetic LDPC code construction + ALIST writing.

A copy of the JAX package's ``models/generate.py`` (the port imports
nothing from that package).

The reference ships a static database of 119 ALIST files; this module lets
the framework operate standalone: Gallager-style regular LDPC ensembles for
arbitrary (n, dv, dc), the classic Hamming(7,4) code (same parameters as the
reference's BCH_7_4_1 matrix), and an ALIST writer so generated codes can be
stored in the interchange format the parser reads.
"""

from __future__ import annotations

import numpy as np

from ldpc_tpu_torch.models.alist import AlistMatrix


def hamming_7_4() -> AlistMatrix:
    """Hamming (7,4): the textbook 3x7 parity-check matrix."""
    H = np.array(
        [
            [1, 0, 1, 0, 1, 0, 1],
            [0, 1, 1, 0, 0, 1, 1],
            [0, 0, 0, 1, 1, 1, 1],
        ],
        dtype=np.uint8,
    )
    rows, cols = np.nonzero(H)
    return AlistMatrix(n=7, m=3, row_idx=rows.astype(np.int32), col_idx=cols.astype(np.int32))


def gallager_regular(
    n: int, dv: int = 3, dc: int = 6, seed: int = 0
) -> AlistMatrix:
    """(dv, dc)-regular Gallager ensemble: dv stacked permutation tiers.

    Each tier partitions a random column permutation into groups of dc, one
    group per check. Tiers occupy disjoint row ranges and a permutation
    never repeats a column within a tier, so the result is exactly
    (dv, dc)-regular by construction.
    """
    if (n * dv) % dc != 0:
        raise ValueError(f"n*dv must be divisible by dc (n={n}, dv={dv}, dc={dc})")
    m = n * dv // dc
    tier_rows = m // dv
    if tier_rows * dv != m:
        raise ValueError("dv must divide m = n*dv/dc")

    rng = np.random.default_rng(seed)
    rows: list[int] = []
    cols: list[int] = []
    for tier in range(dv):
        perm = rng.permutation(n)
        for i in range(tier_rows):
            for j in range(dc):
                rows.append(tier * tier_rows + i)
                cols.append(int(perm[i * dc + j]))

    order = np.lexsort((cols, rows))
    return AlistMatrix(
        n=n,
        m=m,
        row_idx=np.asarray(rows, dtype=np.int32)[order],
        col_idx=np.asarray(cols, dtype=np.int32)[order],
    )


def qc_girth6_shifts(
    base_edges: list[tuple[int, int]],
    Z: int,
    rng: np.random.Generator,
    fixed: dict[tuple[int, int], int] | None = None,
    max_tries: int = 200,
) -> dict[tuple[int, int], int] | None:
    """Assign circulant shifts so the lifted graph has girth >= 6.

    A lifted 4-cycle exists iff two base rows i1 != i2 share columns j1 != j2
    with s(i1,j1) - s(i2,j1) == s(i1,j2) - s(i2,j2) (mod Z). Shifts are drawn
    greedily in random edge order, rejecting any that closes such a cycle
    with the shifts already placed; returns None if a full assignment was not
    found in ``max_tries`` restarts.
    """
    fixed = fixed or {}
    cols_of_row: dict[int, list[int]] = {}
    for r, c in base_edges:
        cols_of_row.setdefault(r, []).append(c)
    rows_of_col: dict[int, list[int]] = {}
    for r, c in base_edges:
        rows_of_col.setdefault(c, []).append(r)

    free_edges = [e for e in base_edges if e not in fixed]
    for _ in range(max_tries):
        shifts = dict(fixed)
        rng.shuffle(free_edges)
        ok = True
        for (r, c) in free_edges:
            # forbidden values: for each other row r2 on column c and each
            # shared column c2, s = s(r2,c) + s(r,c2) - s(r2,c2) mod Z
            forbidden = set()
            for r2 in rows_of_col[c]:
                if r2 == r or (r2, c) not in shifts:
                    continue
                for c2 in cols_of_row[r]:
                    if c2 == c:
                        continue
                    if (r, c2) in shifts and (r2, c2) in shifts:
                        forbidden.add(
                            (shifts[(r2, c)] + shifts[(r, c2)] - shifts[(r2, c2)])
                            % Z
                        )
            if len(forbidden) >= Z:
                ok = False
                break
            while True:
                s = int(rng.integers(Z))
                if s not in forbidden:
                    break
            shifts[(r, c)] = s
        if ok:
            return shifts
    return None


def wimax_like(Z: int, seed: int = 0) -> AlistMatrix:
    """Rate-1/2 QC-LDPC at an arbitrary lift size with girth >= 6.

    Uses the IEEE 802.16e rate-1/2 base GRAPH (the edge positions of the
    12 x 24 base matrix, with its dual-diagonal parity structure and fixed
    zero shifts) but draws fresh information-part shifts, generalizing the
    reference's four shipped ``wimaxlike_*_set0`` files
    (`Channel_Codes_Database/Custom LDPC Codes/`) to any Z.
    """
    from ldpc_tpu_torch.models.standards import WIMAX_R12, expand_base, parse_base_table

    table = parse_base_table(WIMAX_R12)
    mb, nb = len(table), len(table[0])
    base_edges = [
        (r, c) for r in range(mb) for c in range(nb) if table[r][c]
    ]
    # parity part: columns > 12 keep the dual-diagonal structure's zero
    # shifts. Column 12's three shifts are drawn randomly like the info part
    # (the reference's wimaxlike_*_set0 files do the same -- e.g. 0/2/7 in
    # the P8 set -- giving up 802.16e's paired-value back-substitution
    # shortcut; encoding here goes through the generic standard form anyway).
    fixed = {
        (r, c): 0 for (r, c) in base_edges if c > mb
    }
    rng = np.random.default_rng(seed)
    shifts = qc_girth6_shifts(base_edges, Z, rng, fixed=fixed)
    if shifts is None:
        raise RuntimeError(f"No girth-6 shift assignment found for Z={Z}")
    lifted = tuple(
        tuple(
            (shifts[(r, c)],) if table[r][c] else () for c in range(nb)
        )
        for r in range(mb)
    )
    return expand_base(lifted, Z=Z)


def qc_random(
    mb: int, nb: int, Z: int, row_weight: int, seed: int = 0
) -> AlistMatrix:
    """Random regular QC-LDPC with girth >= 6: ``row_weight`` circulants per
    base row, base columns chosen to balance column weights."""
    if not 0 < row_weight <= nb:
        raise ValueError(f"row_weight={row_weight} must be in [1, nb={nb}]")
    rng = np.random.default_rng(seed)
    col_deg = np.zeros(nb, dtype=np.int64)
    base_edges: list[tuple[int, int]] = []
    for r in range(mb):
        # pick the currently lightest columns (random tie-break)
        order = rng.permutation(nb)
        cols = order[np.argsort(col_deg[order], kind="stable")][:row_weight]
        for c in cols:
            base_edges.append((r, int(c)))
            col_deg[c] += 1
    shifts = qc_girth6_shifts(base_edges, Z, rng)
    if shifts is None:
        raise RuntimeError(
            f"No girth-6 assignment for mb={mb}, nb={nb}, Z={Z}, "
            f"row_weight={row_weight}; increase Z or lower the density"
        )
    rows, cols = [], []
    rr = np.arange(Z, dtype=np.int32)
    for (r, c), s in sorted(shifts.items()):
        rows.append(r * Z + rr)
        cols.append(c * Z + (rr + s) % Z)
    row_idx = np.concatenate(rows)
    col_idx = np.concatenate(cols)
    order = np.lexsort((col_idx, row_idx))
    return AlistMatrix(
        n=nb * Z, m=mb * Z,
        row_idx=row_idx[order].astype(np.int32),
        col_idx=col_idx[order].astype(np.int32),
    )


def write_alist(matrix: AlistMatrix, path: str) -> None:
    """Serialize in the dialect the parser reads (N M header, 1-based,
    zero-padded fixed-width index rows)."""
    col_deg = matrix.col_degrees()
    row_deg = matrix.row_degrees()
    dv, dc = int(col_deg.max(initial=0)), int(row_deg.max(initial=0))

    col_lists: list[list[int]] = [[] for _ in range(matrix.n)]
    row_lists: list[list[int]] = [[] for _ in range(matrix.m)]
    for r, c in zip(matrix.row_idx, matrix.col_idx):
        col_lists[c].append(int(r) + 1)
        row_lists[r].append(int(c) + 1)

    def fixed(entries: list[int], width: int) -> str:
        return " ".join(str(e) for e in entries + [0] * (width - len(entries)))

    with open(path, "w") as fh:
        fh.write(f"{matrix.n} {matrix.m}\n")
        fh.write(f"{dv} {dc}\n")
        fh.write(" ".join(str(int(d)) for d in col_deg) + "\n")
        fh.write(" ".join(str(int(d)) for d in row_deg) + "\n")
        for entries in col_lists:
            fh.write(fixed(entries, dv) + "\n")
        for entries in row_lists:
            fh.write(fixed(entries, dc) + "\n")
