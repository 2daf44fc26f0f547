"""Catalog of available LDPC matrices for adaptive rate selection.

A copy of the JAX package's ``models/catalog.py`` (the port imports
nothing from that package).

Same filename grammar and navigation queries as the reference
(`python_ldpc_app/matrix_catalog.py:21-203`): per-family regexes with an
ALIST-header fallback, rate-range / family / nearest-rate queries, and
next-lower / next-higher rate navigation preferring the same family and
block size.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass


@dataclass
class MatrixInfo:
    """Metadata about an ALIST matrix file."""

    path: str
    name: str
    n: int
    k: int
    m: int
    rate: float
    family: str  # 'wimax', 'ccsds', 'bch', 'wifi', 'wran', 'wigig', 'custom', 'unknown'


_PATTERNS = [
    # wimax_576_0.5.alist.txt, wimax_960_0.66B.alist.txt
    (
        re.compile(r"wimax_(\d+)_([\d.]+[A-B]?)\.alist\.txt"),
        lambda g: _from_n_rate(int(g[0]), float(re.sub(r"[A-Za-z]", "", g[1])), "wimax"),
    ),
    # CCSDS_ldpc_n128_k64.alist.txt
    (
        re.compile(r"CCSDS_ldpc_n(\d+)_k(\d+)\.alist\.txt"),
        lambda g: _from_n_k(int(g[0]), int(g[1]), "ccsds"),
    ),
    # wifi_648_r083.alist.txt
    (
        re.compile(r"wifi_(\d+)_r(\d+)\.alist\.txt"),
        lambda g: _from_n_rate(int(g[0]), int(g[1]) / 100.0, "wifi"),
    ),
    # wigig_R05_N672_K336.alist.txt
    (
        re.compile(r"wigig_R(\d+)_N(\d+)_K(\d+)\.alist\.txt"),
        lambda g: _from_n_k(int(g[1]), int(g[2]), "wigig"),
    ),
    # WRAN_N384_K192_P16_R05.txt
    (
        re.compile(r"WRAN_N(\d+)_K(\d+)_P\d+_R(\d+)\.txt"),
        lambda g: _from_n_k(int(g[0]), int(g[1]), "wran"),
    ),
    # BCH_7_4_1_strip.alist.txt
    (
        re.compile(r"BCH_(\d+)_(\d+)_\d+"),
        lambda g: _from_n_k(int(g[0]), int(g[1]), "bch"),
    ),
    # Tanner_155_64.alist.txt
    (
        re.compile(r"Tanner_(\d+)_(\d+)\.alist\.txt"),
        lambda g: _from_n_k(int(g[0]), int(g[1]), "custom"),
    ),
    # LDPC_N336_K196_ITU_G.h.alist.txt and similar
    (
        re.compile(r"LDPC_N(\d+)_K(\d+)"),
        lambda g: _from_n_k(int(g[0]), int(g[1]), "custom"),
    ),
    # ieee_802_11ad_p42_n672_r081.alist.txt (rate 13/16)
    (
        re.compile(r"ieee_802_11ad_p\d+_n(\d+)_r\d+\.alist\.txt"),
        lambda g: _from_n_k(int(g[0]), int(g[0]) * 13 // 16, "wigig"),
    ),
    # wimaxlike_N192_K96_P8_set0.txt
    (
        re.compile(r"wimaxlike_N(\d+)_K(\d+)_P\d+_set\d+\.txt"),
        lambda g: _from_n_k(int(g[0]), int(g[1]), "custom"),
    ),
]


def _from_n_rate(n: int, rate: float, family: str) -> tuple[int, int, float, str]:
    k = int(round(n * rate))
    return n, k, rate, family


def _from_n_k(n: int, k: int, family: str) -> tuple[int, int, float, str]:
    return n, k, (k / n if n > 0 else 0.0), family


class MatrixCatalog:
    """Registry of available LDPC matrices, indexed by properties.

    Sources: an ALIST directory tree (the reference's only source,
    matrix_catalog.py:30-39) and/or the built-in standard code registry
    (ldpc_tpu_torch.models.standards, paths ``builtin:<name>``). With no directory,
    the catalog is fully populated from builtins, so adaptive rate switching
    works with no database on disk.
    """

    def __init__(self, base_dir: str | None = None, include_builtin: bool | None = None):
        self.matrices: list[MatrixInfo] = []
        scanned = False
        if base_dir is not None and os.path.isdir(base_dir):
            self._scan_directory(base_dir)
            scanned = True
        if include_builtin or (include_builtin is None and not scanned):
            self._add_builtins()
        self.matrices.sort(key=lambda m: (m.family, m.rate, m.n))

    def _add_builtins(self) -> None:
        from ldpc_tpu_torch.models import standards

        known = {m.name for m in self.matrices}
        for name in standards.builtin_names():
            if name in known:
                continue
            info = self._parse_filename(f"builtin:{name}", name)
            if info:
                self.matrices.append(info)

    def _scan_directory(self, base_dir: str) -> None:
        for root, _dirs, files in os.walk(base_dir):
            for fname in files:
                if not fname.endswith(".alist.txt") and not fname.endswith(".txt"):
                    continue
                filepath = os.path.join(root, fname)
                info = self._parse_filename(filepath, fname)
                if info:
                    self.matrices.append(info)

    def _parse_filename(self, filepath: str, fname: str) -> MatrixInfo | None:
        for pattern, extract in _PATTERNS:
            m = pattern.match(fname)
            if m:
                n, k, rate, family = extract(m.groups())
                return MatrixInfo(
                    path=filepath, name=fname, n=n, k=k, m=n - k, rate=rate, family=family
                )
        return self._parse_alist_header(filepath, fname)

    @staticmethod
    def _parse_alist_header(filepath: str, fname: str) -> MatrixInfo | None:
        try:
            with open(filepath, "r") as fh:
                parts = fh.readline().split()
            if len(parts) >= 2:
                n, m_val = int(parts[0]), int(parts[1])
                k = n - m_val
                return MatrixInfo(
                    path=filepath, name=fname, n=n, k=k, m=m_val,
                    rate=k / n if n > 0 else 0.0, family="unknown",
                )
        except (ValueError, IOError):
            pass
        return None

    # ---------------------------------------------------------------- queries

    def get_by_rate_range(self, min_rate: float, max_rate: float) -> list[MatrixInfo]:
        return [m for m in self.matrices if min_rate <= m.rate <= max_rate]

    def get_by_family(self, family: str) -> list[MatrixInfo]:
        return [m for m in self.matrices if m.family == family]

    def get_nearest_rate(
        self, target_rate: float, family: str | None = None, block_size: int | None = None
    ) -> MatrixInfo | None:
        candidates = self.matrices
        if family:
            candidates = [m for m in candidates if m.family == family]
        if block_size:
            candidates = [m for m in candidates if m.n == block_size]
        if not candidates:
            return None
        return min(candidates, key=lambda m: abs(m.rate - target_rate))

    def get_lower_rate(self, current: MatrixInfo) -> MatrixInfo | None:
        """Next lower-rate matrix, preferring same family + block size."""
        candidates = [
            m for m in self.matrices
            if m.family == current.family and m.n == current.n and m.rate < current.rate
        ]
        if not candidates:
            candidates = [
                m for m in self.matrices
                if m.family == current.family and m.rate < current.rate
            ]
        if not candidates:
            return None
        return max(candidates, key=lambda m: m.rate)

    def get_higher_rate(self, current: MatrixInfo) -> MatrixInfo | None:
        """Next higher-rate matrix, preferring same family + block size."""
        candidates = [
            m for m in self.matrices
            if m.family == current.family and m.n == current.n and m.rate > current.rate
        ]
        if not candidates:
            candidates = [
                m for m in self.matrices
                if m.family == current.family and m.rate > current.rate
            ]
        if not candidates:
            return None
        return min(candidates, key=lambda m: m.rate)

    def find_by_path(self, matrix_path: str) -> MatrixInfo | None:
        target = os.path.abspath(matrix_path)
        for m in self.matrices:
            if os.path.abspath(m.path) == target:
                return m
        # fall back to basename matching (builtin: URIs, bare DB names)
        base = os.path.basename(matrix_path[len("builtin:"):]
                                if matrix_path.startswith("builtin:")
                                else matrix_path)
        for m in self.matrices:
            if m.name == base:
                return m
        return None

    def __len__(self) -> int:
        return len(self.matrices)

    def __repr__(self) -> str:
        families: dict[str, int] = {}
        for m in self.matrices:
            families[m.family] = families.get(m.family, 0) + 1
        parts = [f"{f}={c}" for f, c in sorted(families.items())]
        return f"MatrixCatalog({len(self.matrices)} matrices: {', '.join(parts)})"
