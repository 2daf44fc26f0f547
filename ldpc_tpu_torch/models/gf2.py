"""Bit-packed GF(2) linear algebra on uint64 words.

The reference performs load-time Gaussian elimination with interpreted
per-element scipy.sparse LIL loops (`python_ldpc_app/encoder_decoder_data.py:13-183`),
which is O(m*n*deg) Python operations. Here rows are packed 64 bits per word
and eliminated with whole-row XORs via numpy, making n >= 4096 codes load in
milliseconds. All functions are pure host-side numpy -- this layer runs once
per code at load time; device compute lives in ldpc_tpu_torch.ops.
"""

from __future__ import annotations

import numpy as np

WORD = 64


def pack_rows(dense: np.ndarray) -> np.ndarray:
    """Pack a binary matrix [m, n] (any integer/bool dtype) into uint64 [m, w]."""
    dense = np.asarray(dense)
    m, n = dense.shape
    bits = (dense & 1).astype(np.uint8)
    pad = (-n) % WORD
    if pad:
        bits = np.concatenate([bits, np.zeros((m, pad), dtype=np.uint8)], axis=1)
    # little-endian within each word: column c lives in word c//64, bit c%64
    words = bits.reshape(m, -1, WORD).astype(np.uint64)
    shifts = np.arange(WORD, dtype=np.uint64)
    return (words << shifts).sum(axis=2, dtype=np.uint64)


def unpack_rows(packed: np.ndarray, n: int) -> np.ndarray:
    """Unpack uint64 [m, w] back to uint8 [m, n]."""
    m, w = packed.shape
    shifts = np.arange(WORD, dtype=np.uint64)
    bits = ((packed[:, :, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    return bits.reshape(m, w * WORD)[:, :n]


def get_bit(packed: np.ndarray, row: int, col: int) -> int:
    return int((packed[row, col // WORD] >> np.uint64(col % WORD)) & np.uint64(1))


def set_bit(packed: np.ndarray, row: int, col: int, value: int) -> None:
    mask = np.uint64(1) << np.uint64(col % WORD)
    if value:
        packed[row, col // WORD] |= mask
    else:
        packed[row, col // WORD] &= ~mask


def rref(
    packed: np.ndarray, n: int, col_order: np.ndarray | None = None
) -> tuple[np.ndarray, list[int]]:
    """Reduced row-echelon form over GF(2).

    Scans columns in ``col_order`` (default 0..n-1), picking for each the first
    unprocessed row with a 1 and XOR-eliminating every other row -- the same
    RREF (pivot columns in encounter order) the reference's two-phase
    eliminate-then-back-diagonalize produces. Returns ``(reduced, pivot_cols)``;
    ``reduced`` is a new array.
    """
    M = packed.copy()
    m = M.shape[0]
    if col_order is None:
        col_order = np.arange(n)
    pivot_cols: list[int] = []
    cur_row = 0
    one = np.uint64(1)
    for col in col_order:
        if cur_row >= m:
            break
        wi, bi = col // WORD, np.uint64(col % WORD)
        col_bits = (M[:, wi] >> bi) & one
        candidates = np.nonzero(col_bits[cur_row:])[0]
        if candidates.size == 0:
            continue  # linearly dependent column
        pivot = cur_row + int(candidates[0])
        if pivot != cur_row:
            M[[cur_row, pivot]] = M[[pivot, cur_row]]
            col_bits[[cur_row, pivot]] = col_bits[[pivot, cur_row]]
        # XOR the pivot row into every other row that has a 1 in this column.
        targets = col_bits.astype(bool)
        targets[cur_row] = False
        M[targets] ^= M[cur_row]
        pivot_cols.append(int(col))
        cur_row += 1
    return M, pivot_cols


def rank(packed: np.ndarray, n: int) -> int:
    return len(rref(packed, n)[1])


def matmul_t(a_packed: np.ndarray, b_packed: np.ndarray) -> np.ndarray:
    """GF(2) product A @ B.T for packed A [p, w], B [q, w] -> uint8 [p, q].

    Each output entry is popcount(row_a & row_b) mod 2.
    """
    ands = a_packed[:, None, :] & b_packed[None, :, :]
    return (np.bitwise_count(ands).sum(axis=2) & 1).astype(np.uint8)


def matvec(packed: np.ndarray, v_packed: np.ndarray) -> np.ndarray:
    """GF(2) matrix-vector product: packed [m, w] @ v_packed [w] -> uint8 [m]."""
    ands = packed & v_packed[None, :]
    return (np.bitwise_count(ands).sum(axis=1) & 1).astype(np.uint8)


def solve_unit_lower_triangular(T: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve T x = b over GF(2) by forward substitution.

    ``T`` is dense uint8 [t, t], lower triangular with unit diagonal;
    ``b`` is uint8 [t] or [t, r] (multiple right-hand sides).
    """
    T = np.asarray(T, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    single = b.ndim == 1
    if single:
        b = b[:, None]
    t = T.shape[0]
    x = np.zeros_like(b)
    for i in range(t):
        acc = (T[i, :i][None, :i] @ x[:i]) & 1 if i else 0
        x[i] = b[i] ^ (acc & 1)
    return x[:, 0] if single else x


def invert(dense: np.ndarray) -> np.ndarray | None:
    """Invert a dense binary matrix over GF(2); returns None if singular."""
    g = np.asarray(dense, dtype=np.uint8) & 1
    t = g.shape[0]
    if t == 0:
        return np.zeros((0, 0), dtype=np.uint8)
    aug = np.concatenate([g, np.eye(t, dtype=np.uint8)], axis=1)
    packed = pack_rows(aug)
    reduced, pivots = rref(packed, 2 * t, col_order=np.arange(t))
    if len(pivots) != t or pivots != list(range(t)):
        return None
    return unpack_rows(reduced, 2 * t)[:, t:]
