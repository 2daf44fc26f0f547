"""Richardson-Urbanke encoding preparation.

A copy of the JAX package's ``models/ru.py`` (numpy only; the port imports
nothing from that package).

The reference attempts an approximate-lower-triangular (ALT) decomposition
(`python_ldpc_app/encoder_decoder_data.py:346-716`) but its greedy search in
practice falls back to the standard form with gap 0, and its gap > 0 encoder
is unimplemented (`python_ldpc_app/data_buffer.py:339-345` leaves p1 = 0 with
a TODO). This module implements the classical RU construction correctly:

1. Greedy diagonal-extension permutation of the *original* H into
   ``[A B T; C D E]`` with T unit-lower-triangular and gap g (Richardson &
   Urbanke 2001, "Efficient encoding of low-density parity-check codes",
   greedy algorithm).
2. phi = D + E T^-1 B over GF(2); if singular, B-columns are re-chosen among
   the non-diagonal columns until phi is invertible (with a bounded number of
   attempts), else the decomposition falls back to the trivial
   H_std = [A | I_m] form (gap 0) like the reference's fallback
   (`encoder_decoder_data.py:523-552`).
3. The whole encoder is then lowered to a dense parity-generator matmul
   ``parity = u @ P mod 2`` plus a column gather into the H_std domain
   (EncodeSpec) -- on the device, a precomputed matrix product beats sparse
   back-substitution, so the O(n) sparse encode of the paper is folded into
   load-time precomputation:
      p1 = W1 @ s  with W1 = phi^-1 (C + E T^-1 A)
      p2 = W2 @ s  with W2 = T^-1 (A + B W1)
"""

from __future__ import annotations

import numpy as np

from ldpc_tpu_torch.models import gf2


def alt_decomposition(H: np.ndarray, rng: np.random.Generator):
    """Greedy ALT form of a dense binary H [m, n].

    Returns ``(diag_rows, diag_cols, gap_rows)`` where processing order is
    such that reversing ``diag_rows``/``diag_cols`` yields a unit
    lower-triangular T; ``gap_rows`` are the rows demoted to the gap.
    """
    m, n = H.shape
    remaining_rows = np.ones(m, dtype=bool)
    alive_cols = np.ones(n, dtype=bool)
    Hm = H.astype(np.int32)
    # residual degree per column over remaining rows, updated incrementally
    res_deg = Hm.sum(axis=0).astype(np.int64)
    BIG = np.int64(1) << 40

    diag_rows: list[int] = []
    diag_cols: list[int] = []
    gap_rows: list[int] = []

    n_remaining = m
    while n_remaining:
        deg = np.where(alive_cols & (res_deg > 0), res_deg, BIG)
        c = int(np.argmin(deg))
        if deg[c] == BIG:
            # Remaining rows are all-zero over remaining columns (dependent
            # rows) -- demote them to the gap.
            gap_rows.extend(np.nonzero(remaining_rows)[0].tolist())
            break
        rows_of_c = np.nonzero(Hm[:, c] & remaining_rows)[0]
        # pick one row for the diagonal; demote the others to the gap
        r = int(rows_of_c[0])
        for extra in rows_of_c[1:]:
            gap_rows.append(int(extra))
        for dead in rows_of_c:
            remaining_rows[dead] = False
            res_deg -= Hm[dead]
            n_remaining -= 1
        alive_cols[c] = False
        diag_rows.append(r)
        diag_cols.append(c)

    return diag_rows, diag_cols, gap_rows


def prepare_richardson_urbanke(code, target_gap: int | None = None, seed: int = 0):
    """Build a Richardson-Urbanke EncodeSpec for ``code`` (an LDPCCode).

    ``target_gap``: if given and >= the greedy gap, extra diagonal pairs are
    demoted so the decomposition uses exactly that gap (mirrors the
    reference's --ru-gap flag); if smaller than achievable, the greedy gap is
    used with a warning, like `encoder_decoder_data.py:588-591`.
    """
    from ldpc_tpu_torch.models.code import EncodeSpec

    rng = np.random.default_rng(seed)
    H = code.H.to_dense().astype(np.uint8)
    if code.rank_deficient:
        # Operate on the cleaned full-rank H_std-equivalent instead: undo the
        # column permutation of H_std to recover a full-rank row basis in the
        # original column order.
        h_std = code.h_std_dense()
        H = np.zeros((code.m, code.n), dtype=np.uint8)
        H[:, code.permutation] = h_std
    m, n = H.shape
    k = n - m

    diag_rows, diag_cols, gap_rows = alt_decomposition(H, rng)
    gap = len(gap_rows)

    if target_gap is not None:
        if target_gap < gap:
            print(
                f"Warning: requested RU gap={target_gap} below achievable "
                f"minimum {gap}; using gap={gap}"
            )
        else:
            while gap < target_gap and len(diag_rows) > 0:
                gap_rows.append(diag_rows.pop())
                diag_cols.pop()
                gap += 1

    t_size = len(diag_rows)
    assert t_size + gap == m, (t_size, gap, m)

    # Reverse selection order => unit lower-triangular T.
    t_rows = diag_rows[::-1]
    t_cols = diag_cols[::-1]
    row_perm = np.asarray(t_rows + gap_rows, dtype=np.int32)

    non_diag_cols = [c for c in range(n) if c not in set(t_cols)]

    def build(col_choice: list[int]):
        """col_choice: g columns for the B/D block from non_diag_cols."""
        b_set = set(col_choice)
        a_cols = [c for c in non_diag_cols if c not in b_set]
        col_perm = np.asarray(a_cols + col_choice + t_cols, dtype=np.int32)
        Hp = H[row_perm][:, col_perm]
        A = Hp[:t_size, :k]
        B = Hp[:t_size, k : k + gap]
        T = Hp[:t_size, k + gap :]
        C = Hp[t_size:, :k]
        D = Hp[t_size:, k : k + gap]
        E = Hp[t_size:, k + gap :]
        assert np.array_equal(np.tril(T), T) and (np.diag(T) == 1).all(), "T not unit lower triangular"
        Tinv_B = gf2.solve_unit_lower_triangular(T, B) if gap else np.zeros((t_size, 0), np.uint8)
        phi = (D ^ ((E.astype(np.int64) @ Tinv_B) & 1).astype(np.uint8)) if gap else np.zeros((0, 0), np.uint8)
        phi_inv = gf2.invert(phi)
        return col_perm, A, B, T, C, E, phi_inv

    # Try B-column choices until phi is invertible.
    attempt_cols = list(non_diag_cols[k:])  # default: last g non-diag columns
    result = None
    for attempt in range(32):
        col_perm, A, B, T, C, E, phi_inv = build(attempt_cols)
        if gap == 0 or phi_inv is not None:
            result = (col_perm, A, B, T, C, E, phi_inv)
            break
        attempt_cols = sorted(rng.choice(len(non_diag_cols), size=gap, replace=False).tolist())
        attempt_cols = [non_diag_cols[i] for i in attempt_cols]
    if result is None:
        # Fallback: trivial ALT from the standard form (gap 0, T = I_m), the
        # same safety net as the reference (encoder_decoder_data.py:523-552).
        return _trivial_spec(code)

    col_perm, A, B, T, C, E, phi_inv = result

    # Precompute parity generators (dense GF(2), int64 matmuls stay exact).
    Tinv_A = gf2.solve_unit_lower_triangular(T, A)
    if gap:
        W1 = (phi_inv.astype(np.int64) @ ((C.astype(np.int64) + E.astype(np.int64) @ Tinv_A) & 1) & 1).astype(np.uint8)
        AB = (A.astype(np.int64) + B.astype(np.int64) @ W1) & 1
        W2 = gf2.solve_unit_lower_triangular(T, AB.astype(np.uint8))
    else:
        W1 = np.zeros((0, k), dtype=np.uint8)
        W2 = Tinv_A

    # Parity order in the RU domain: x_ru = [s, p1, p2]; P maps u -> [p1, p2].
    P = np.concatenate([W1.T, W2.T], axis=1).astype(np.uint8)  # [k, m]

    # Map the RU-domain word into each decode domain:
    #   original order: v[col_perm[i]] = x_ru[i]  =>  map_orig = pos_in_ru
    #   std order:      w[j] = v[perm_std[j]]     =>  map_std = pos_in_ru[perm_std]
    pos_in_ru = np.empty(n, dtype=np.int32)
    pos_in_ru[col_perm] = np.arange(n, dtype=np.int32)

    spec = EncodeSpec(
        method="richardson_urbanke",
        P=P,
        map_std=pos_in_ru[code.permutation].astype(np.int32),
        map_orig=pos_in_ru.astype(np.int32),
        gap=gap,
    )

    _verify_spec(code, spec)
    return spec


def _trivial_spec(code):
    """Gap-0 RU encoder == standard encoder (fallback path)."""
    from ldpc_tpu_torch.models.code import EncodeSpec

    std = code.standard_encode_spec
    return EncodeSpec(
        method="richardson_urbanke",
        P=std.P,
        map_std=std.map_std,
        map_orig=std.map_orig,
        gap=0,
    )


def _verify_spec(code, spec, trials: int = 4, seed: int = 1) -> None:
    """Self-check: random info words must encode to H_std codewords and the
    info bits must be recoverable at info_pos_std (the loud validation the
    reference performs per block at data_buffer.py:433-458, done once here)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(trials, code.k), dtype=np.uint8)
    for graph, syndrome in (("std", code.syndrome_std), ("orig", code.syndrome_orig)):
        w = spec.encode_numpy(u, graph)
        syn = syndrome(w.T)
        if syn.any():
            raise ValueError(
                f"Richardson-Urbanke encoding produced invalid codewords in the "
                f"{graph} domain (syndrome weight {int(syn.sum())}, gap={spec.gap})"
            )
        if not np.array_equal(w[:, spec.info_pos(graph)], u):
            raise ValueError("Richardson-Urbanke info-bit mapping is inconsistent")
