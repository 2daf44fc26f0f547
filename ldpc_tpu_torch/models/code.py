"""LDPC code construction: standard form, generator, padded edge layout.

A copy of the JAX package's ``models/code.py`` (the port imports nothing
from that package): Gauss-Jordan over GF(2) on bit-packed rows, trimming of
rank-deficient matrices, the systematic generator G = [I_k | A^T], the padded
edge layout, and the quasi-cyclic factorization the CUDA decode loop runs on.

Both encoders lower to one EncodeSpec: the standard systematic encoder
(G = [I_k | A^T]) and the Richardson-Urbanke encoder (ldpc_tpu_torch.models.ru).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from ldpc_tpu_torch.models import gf2
from ldpc_tpu_torch.models.alist import AlistMatrix, read_alist


@dataclass(frozen=True)
class EdgeLayout:
    """Padded fixed-degree Tanner-graph layout of H_std for device decoding.

    Message arrays live check-major with shape [..., m, dc]; flat edge id of
    slot (r, s) is ``r * dc + s``. Padding slots point at sentinel indices
    (variable ``n``, edge ``m * dc``) whose values are defined to be neutral
    (LLR/message 0, bit 0), keeping reductions exact for irregular codes.
    """

    n: int
    m: int
    dc: int  # max check-node degree
    dv: int  # max variable-node degree
    n_edges: int
    chk_var: np.ndarray  # int32 [m, dc]  variable index per check slot, pad = n
    var_edge: np.ndarray  # int32 [n, dv]  flat edge ids per variable, pad = m*dc
    chk_deg: np.ndarray  # int32 [m]
    var_deg: np.ndarray  # int32 [n]


def build_edge_layout(n: int, m: int, row_idx: np.ndarray, col_idx: np.ndarray) -> EdgeLayout:
    """Compile a sparse (row, col) structure into an :class:`EdgeLayout`."""
    chk_deg = np.bincount(row_idx, minlength=m).astype(np.int32)
    var_deg = np.bincount(col_idx, minlength=n).astype(np.int32)
    dc = int(chk_deg.max()) if m else 0
    dv = int(var_deg.max()) if n else 0
    n_edges = int(row_idx.shape[0])

    chk_var = np.full((m, dc), n, dtype=np.int32)
    # row-major sorted input -> slot index is the running position within a row
    order = np.lexsort((col_idx, row_idx))
    r_sorted, c_sorted = row_idx[order], col_idx[order]
    starts = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(chk_deg, out=starts[1:])
    slots = np.arange(n_edges, dtype=np.int64) - starts[r_sorted]
    chk_var[r_sorted, slots] = c_sorted
    edge_ids = (r_sorted.astype(np.int64) * dc + slots).astype(np.int32)

    var_edge = np.full((n, dv), m * dc, dtype=np.int32)
    vorder = np.lexsort((r_sorted, c_sorted))
    v_sorted = c_sorted[vorder]
    e_sorted = edge_ids[vorder]
    vstarts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(var_deg, out=vstarts[1:])
    vslots = np.arange(n_edges, dtype=np.int64) - vstarts[v_sorted]
    var_edge[v_sorted, vslots] = e_sorted

    return EdgeLayout(
        n=n, m=m, dc=dc, dv=dv, n_edges=n_edges,
        chk_var=chk_var, var_edge=var_edge, chk_deg=chk_deg, var_deg=var_deg,
    )


@dataclass(frozen=True)
class EncodeSpec:
    """Systematic encoder as one GF(2) matrix product.

    The assembled word is ``x = concat(u, u @ P mod 2)`` with ``P`` uint8
    [k, n - k]; the codeword presented to the channel and decoder is
    ``w = x[domain_map]`` where the domain is the column order of the chosen
    decode graph: ``'std'`` (H_std = [A | I_m], the graph the reference
    decodes on) or ``'orig'`` (the original sparse ALIST H -- the proper LDPC
    decode graph). ``info_pos(graph)`` locates info bit t inside w for BER
    accounting.
    """

    method: str  # 'standard' | 'richardson_urbanke'
    P: np.ndarray
    map_std: np.ndarray  # int32 [n]: w_std[j] = x[map_std[j]]
    map_orig: np.ndarray  # int32 [n]: w_orig[j] = x[map_orig[j]]
    gap: int = 0  # Richardson-Urbanke gap (0 for standard)

    def domain_map(self, graph: str) -> np.ndarray:
        if graph == "std":
            return self.map_std
        if graph in ("orig", "original"):
            return self.map_orig
        raise ValueError(f"Unknown decode graph: {graph}")

    def info_pos(self, graph: str) -> np.ndarray:
        """int32 [k]: domain position of info bit t."""
        dm = self.domain_map(graph)
        k = self.P.shape[0]
        pos_of_x = np.empty(dm.shape[0], dtype=np.int32)
        pos_of_x[dm] = np.arange(dm.shape[0], dtype=np.int32)
        return pos_of_x[:k].copy()

    def encode_numpy(self, u: np.ndarray, graph: str = "std") -> np.ndarray:
        """Reference host-side encode for tests: u uint8 [..., k] -> [..., n]."""
        u = np.asarray(u, dtype=np.uint8)
        parity = (u @ self.P.astype(np.int64)) & 1
        word = np.concatenate([u, parity.astype(np.uint8)], axis=-1)
        return word[..., self.domain_map(graph)]


class LDPCCode:
    """A binary LDPC code loaded from ALIST, prepared for simulation.

    Mirrors the reference `EncoderDecoderData(path)` construction chain
    (`encoder_decoder_data.py:186-267`): parse -> standard form
    H_std = [A | I_m] via Gauss-Jordan + column permutation (with
    rank-deficiency trimming) -> generator G = [I_k | A^T] -> validate
    G @ H_std^T == 0 -> compile decoder layout.
    """

    def __init__(self, path: str | None = None, alist: AlistMatrix | None = None,
                 name: str | None = None):
        if alist is None:
            if path is None:
                raise ValueError("LDPCCode requires a path or an AlistMatrix")
            alist = read_alist(path)
        self.path = path or ""
        self.name = name or (os.path.basename(path) if path else "anonymous")
        self.H = alist

        self.n = alist.n
        m = alist.m
        if self.n == 0:
            raise ValueError("Invalid parity check matrix: matrix is empty")

        packed = gf2.pack_rows(alist.to_dense())
        reduced, pivots = gf2.rref(packed, self.n)

        rank = len(pivots)
        if rank != m:
            # Dependent rows: keep the first `rank` RREF rows (the non-zero
            # ones) and re-reduce, as the reference does
            # (encoder_decoder_data.py:280-305).
            reduced = reduced[:rank]
            reduced, pivots = gf2.rref(reduced, self.n)
            if len(pivots) != rank:
                raise ValueError(
                    f"Internal error: rank changed after trimming dependent rows "
                    f"({len(pivots)} != {rank})"
                )
            m = rank

        self.m = m
        self.k = self.n - m
        self.rate = self.k / self.n if self.n else 0.0
        self.rank_deficient = rank != alist.m

        pivot_set = set(pivots)
        non_pivots = [c for c in range(self.n) if c not in pivot_set]
        # permutation[i] = original column placed at std position i
        self.permutation = np.asarray(non_pivots + pivots, dtype=np.int32)

        dense_reduced = gf2.unpack_rows(reduced, self.n)
        h_std = dense_reduced[:, self.permutation]
        self.A = h_std[:, : self.k].copy()  # H_std = [A | I_m]
        self._h_std_dense = h_std
        self._h_std_packed = gf2.pack_rows(h_std)

        # Validate G @ H_std^T == 0 over GF(2) (encoder_decoder_data.py:221-267).
        g_dense = np.concatenate([np.eye(self.k, dtype=np.uint8), self.A.T], axis=1)
        check = gf2.matmul_t(gf2.pack_rows(g_dense), self._h_std_packed)
        if check.any():
            nz = np.argwhere(check)[:5]
            raise ValueError(
                "Invalid generator matrix: G * H^T != 0. "
                f"Non-zero elements: {int(check.sum())}. Sample positions: {nz.tolist()}"
            )

        # std position of each original column: stdpos[permutation[i]] = i
        self._stdpos = np.empty(self.n, dtype=np.int32)
        self._stdpos[self.permutation] = np.arange(self.n, dtype=np.int32)

        rows, cols = np.nonzero(h_std)
        self.layout_std = build_edge_layout(
            self.n, self.m, rows.astype(np.int32), cols.astype(np.int32)
        )
        # Decode graph over the ORIGINAL sparse H (all rows, including any
        # redundant ones -- extra checks are valid and help the SPA). This is
        # the proper LDPC Tanner graph; H_std is kept for bit-exact parity
        # with the reference decoder, which runs on H_std (spa_decoder.py:31).
        self.layout_orig = build_edge_layout(self.n, alist.m, alist.row_idx, alist.col_idx)
        self._ru_cache: dict[int | None, EncodeSpec] = {}

    def layout(self, graph: str = "orig") -> EdgeLayout:
        if graph == "std":
            return self.layout_std
        if graph in ("orig", "original"):
            return self.layout_orig
        raise ValueError(f"Unknown decode graph: {graph}")

    @cached_property
    def qc(self):
        """Quasi-cyclic factorization of the original H, or None.

        When present, the fused CUDA kernels (ldpc_tpu_torch.ops.mc_kernels)
        decode on it.
        """
        from ldpc_tpu_torch.models.qc import detect_qc

        return detect_qc(self.H)

    # ---------------------------------------------------------------- encode

    @cached_property
    def standard_encode_spec(self) -> EncodeSpec:
        """Systematic encoder from G = [I_k | A^T]: x = [u, u @ A^T] is already
        the std-domain word; the orig-domain word scatters through stdpos."""
        return EncodeSpec(
            method="standard",
            P=self.A.T.copy(),
            map_std=np.arange(self.n, dtype=np.int32),
            map_orig=self._stdpos.copy(),
            gap=0,
        )

    def richardson_urbanke_spec(self, gap: int | None = None) -> EncodeSpec:
        """Richardson-Urbanke encoder (see ldpc_tpu_torch.models.ru)."""
        key = gap
        if key not in self._ru_cache:
            from ldpc_tpu_torch.models import ru

            self._ru_cache[key] = ru.prepare_richardson_urbanke(self, target_gap=gap)
        return self._ru_cache[key]

    def encode_spec(self, method: str, ru_gap: int | None = None) -> EncodeSpec:
        if method in ("standard", "STANDARD"):
            return self.standard_encode_spec
        if method in ("richardson-urbanke", "richardson_urbanke", "RICHARDSON_URBANKE"):
            return self.richardson_urbanke_spec(ru_gap)
        raise ValueError(f"Unknown encoding method: {method}")

    # ------------------------------------------------------------ validation

    def h_std_dense(self) -> np.ndarray:
        return self._h_std_dense.copy()

    def syndrome_std(self, word: np.ndarray) -> np.ndarray:
        """H_std @ word mod 2 for a std-domain word (host-side, tests)."""
        return (self._h_std_dense.astype(np.int64) @ np.asarray(word, dtype=np.int64)) & 1

    def syndrome_orig(self, word: np.ndarray) -> np.ndarray:
        """Original H @ word mod 2 for an orig-domain word (host-side, tests)."""
        h = self.H.to_dense().astype(np.int64)
        return (h @ np.asarray(word, dtype=np.int64)) & 1

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        lo = self.layout_orig
        return (
            f"LDPCCode({self.name!r}, n={self.n}, m={self.m}, k={self.k}, "
            f"rate={self.rate:.4f}, edges={lo.n_edges}, dc={lo.dc}, dv={lo.dv})"
        )
