"""ALIST parity-check matrix parser.

Implements the same dialect the reference simulator reads
(`python_ldpc_app/utils.py:21-108`):

  line 1: ``N M``  -- number of columns (variable nodes) FIRST, then rows
  line 2: max column weight, max row weight  (skipped)
  line 3: N column weights                   (validated for count)
  line 4: M row weights                      (validated for count)
  next N lines: per-column 1-based row indices   (skipped -- row lines suffice)
  next M lines: per-row 1-based column indices; ``0`` entries are padding and
                are skipped; blank lines denote empty rows.

Returns plain numpy structures -- no scipy dependency in the hot path; the
downstream GF(2) kernel uses bit-packed uint64 rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class AlistMatrix:
    """A sparse binary parity-check matrix in coordinate form.

    ``n`` columns (variable nodes), ``m`` rows (check nodes); ``row_idx`` /
    ``col_idx`` are parallel int32 arrays of the positions of the 1-entries,
    sorted row-major and deduplicated.
    """

    n: int
    m: int
    row_idx: np.ndarray  # int32 [nnz]
    col_idx: np.ndarray  # int32 [nnz]

    @property
    def nnz(self) -> int:
        return int(self.row_idx.shape[0])

    def to_dense(self) -> np.ndarray:
        """Dense uint8 [m, n] matrix (for tests / small codes)."""
        H = np.zeros((self.m, self.n), dtype=np.uint8)
        H[self.row_idx, self.col_idx] = 1
        return H

    def row_degrees(self) -> np.ndarray:
        return np.bincount(self.row_idx, minlength=self.m).astype(np.int32)

    def col_degrees(self) -> np.ndarray:
        return np.bincount(self.col_idx, minlength=self.n).astype(np.int32)


def _ints(line: str) -> list[int]:
    return [int(tok) for tok in line.split()]


def read_alist(path: str) -> AlistMatrix:
    """Parse an ALIST file into an :class:`AlistMatrix`.

    Raises ``ValueError`` on malformed content (missing dimensions, weight
    count mismatches, out-of-range indices, truncated files), mirroring the
    validation performed by the reference parser.
    """
    with open(path, "r") as fh:
        lines = fh.read().splitlines()

    pos = 0

    def next_line(reason: str) -> str:
        nonlocal pos
        if pos >= len(lines):
            raise ValueError(f"Unexpected end of file: {reason}")
        line = lines[pos]
        pos += 1
        return line

    header = next_line("missing dimensions").strip()
    if not header:
        raise ValueError("Empty file or missing dimensions")
    sizes = _ints(header)
    if len(sizes) < 2:
        raise ValueError("Invalid format: missing dimensions")
    n, m = sizes[0], sizes[1]
    if n <= 0 or m <= 0:
        raise ValueError(f"Invalid dimensions: cols={n}, rows={m}")

    next_line("missing max weights")  # max col/row weight -- unused

    col_weights = _ints(next_line("missing column weights"))
    if len(col_weights) != n:
        raise ValueError(
            f"Column weights count mismatch: expected {n}, got {len(col_weights)}"
        )
    row_weights = _ints(next_line("missing row weights"))
    if len(row_weights) != m:
        raise ValueError(
            f"Row weights count mismatch: expected {m}, got {len(row_weights)}"
        )

    # Skip the N per-column index lines; row lines carry the same information.
    for i in range(n):
        next_line(f"while reading column {i}")

    rows: list[int] = []
    cols: list[int] = []
    i_row = 0
    while i_row < m:
        line = next_line(f"while reading row {i_row}").strip()
        if not line:
            i_row += 1  # blank line == empty row (matches reference)
            continue
        for idx in _ints(line):
            if idx == 0:
                continue  # 0 is padding in fixed-width ALIST rows
            if idx < 1 or idx > n:
                raise ValueError(
                    f"Invalid column index {idx} in row {i_row} (valid range: 1-{n})"
                )
            rows.append(i_row)
            cols.append(idx - 1)
        i_row += 1

    row_idx = np.asarray(rows, dtype=np.int32)
    col_idx = np.asarray(cols, dtype=np.int32)

    # Deduplicate (row, col) pairs and sort row-major for a canonical layout.
    order = np.lexsort((col_idx, row_idx))
    row_idx, col_idx = row_idx[order], col_idx[order]
    if row_idx.size:
        keep = np.ones(row_idx.size, dtype=bool)
        keep[1:] = (np.diff(row_idx) != 0) | (np.diff(col_idx) != 0)
        row_idx, col_idx = row_idx[keep], col_idx[keep]

    return AlistMatrix(n=n, m=m, row_idx=row_idx, col_idx=col_idx)
