"""The port's numpy copies against the JAX package's modules: the
Richardson-Urbanke encoder (``models/ru.py``), the code generators
(``models/generate.py``), the matrix catalog (``models/catalog.py``), graph
statistics and EXIT charts.

Tolerance: none. Every module is integer or float64 numpy arithmetic run in
the same order on both sides, so every output is equal.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import pytest
import torch

from ldpc_tpu.models import catalog as jcat
from ldpc_tpu.models import generate as jgen
from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu_torch.models import catalog as tcat
from ldpc_tpu_torch.models import generate as tgen
from ldpc_tpu_torch.models import standards as tstd
from ldpc_tpu_torch.models.code import LDPCCode as TCode
from ldpc_tpu_torch.ops.encode import make_encoder

torch.set_num_threads(1)

# the modules by name: ldpc_tpu.analysis exports functions of these names
jexit = importlib.import_module("ldpc_tpu.analysis.exit")
jgs = importlib.import_module("ldpc_tpu.analysis.graph_stats")
texit = importlib.import_module("ldpc_tpu_torch.analysis.exit")
tgs = importlib.import_module("ldpc_tpu_torch.analysis.graph_stats")

RU_CODES = ("wimax_576_0.5.alist.txt", "CCSDS_ldpc_n128_k64.alist.txt",
            "LDPC_N336_K196_ITU_G.h.alist.txt")


def _alist_equal(a, b):
    assert (a.n, a.m) == (b.n, b.m)
    np.testing.assert_array_equal(a.row_idx, b.row_idx)
    np.testing.assert_array_equal(a.col_idx, b.col_idx)


def _codes(name=None, alist=None):
    if alist is None:
        return (JCode(alist=jstd.make_builtin(name), name=name),
                TCode(alist=tstd.make_builtin(name), name=name))
    return JCode(alist=alist, name="g"), TCode(alist=alist, name="g")


@pytest.mark.parametrize("name", RU_CODES + ("gallager96",))
def test_richardson_urbanke_spec_matches_jax(name):
    """P, map_std, map_orig and the gap equal the JAX package's; the words
    the port's encoder makes from it satisfy H in both domains."""
    if name == "gallager96":
        jc, tc = _codes(alist=jgen.gallager_regular(96, 3, 6, seed=4))
    else:
        jc, tc = _codes(name)
    want, got = jc.richardson_urbanke_spec(), tc.richardson_urbanke_spec()
    assert got.method == want.method and got.gap == want.gap
    for field in ("P", "map_std", "map_orig"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    u = np.random.default_rng(1).integers(0, 2, (16, tc.k), dtype=np.uint8)
    for graph, syndrome in (("std", tc.syndrome_std), ("orig", tc.syndrome_orig)):
        w = make_encoder(got, graph, "cpu")(torch.from_numpy(u)).numpy()
        w = w.astype(np.uint8)
        assert not syndrome(w.T).any()
        np.testing.assert_array_equal(w[:, got.info_pos(graph)], u)
        np.testing.assert_array_equal(w, want.encode_numpy(u, graph))


def test_richardson_urbanke_gap_request_matches_jax():
    jc, tc = _codes(alist=jgen.gallager_regular(48, 3, 6, seed=11))
    auto = jc.richardson_urbanke_spec()
    want = jc.richardson_urbanke_spec(gap=auto.gap + 2)
    got = tc.richardson_urbanke_spec(gap=auto.gap + 2)
    assert got.gap == want.gap == auto.gap + 2
    np.testing.assert_array_equal(got.P, want.P)
    np.testing.assert_array_equal(got.map_orig, want.map_orig)


def test_generators_match_jax(tmp_path):
    _alist_equal(tgen.hamming_7_4(), jgen.hamming_7_4())
    for args in ((48, 3, 6, 11), (96, 3, 6, 4), (60, 2, 4, 0)):
        _alist_equal(tgen.gallager_regular(*args[:3], seed=args[3]),
                     jgen.gallager_regular(*args[:3], seed=args[3]))
    for Z, seed in ((8, 0), (16, 3)):
        _alist_equal(tgen.wimax_like(Z, seed=seed), jgen.wimax_like(Z, seed=seed))
    _alist_equal(tgen.qc_random(4, 8, 8, 4, seed=1),
                 jgen.qc_random(4, 8, 8, 4, seed=1))
    a = jgen.gallager_regular(48, 3, 6, seed=11)
    tgen.write_alist(a, str(tmp_path / "t.alist"))
    jgen.write_alist(a, str(tmp_path / "j.alist"))
    assert (tmp_path / "t.alist").read_text() == (tmp_path / "j.alist").read_text()


def _infos(catalog):
    return [(m.path, m.name, m.n, m.k, m.m, m.rate, m.family)
            for m in catalog.matrices]


def test_builtin_catalog_matches_jax():
    """The catalog of built-in codes (the adaptive mode's default) and its
    navigation queries."""
    t, j = tcat.MatrixCatalog(), jcat.MatrixCatalog()
    assert _infos(t) == _infos(j) and len(t) > 100 and repr(t) == repr(j)
    for info_t, info_j in zip(t.matrices, j.matrices):
        for q in ("get_lower_rate", "get_higher_rate"):
            a, b = getattr(t, q)(info_t), getattr(j, q)(info_j)
            assert (a and a.path) == (b and b.path)
    for path in ("builtin:wimax_576_0.5.alist.txt", "wimax_1152_0.5.alist.txt",
                 "nope.alist.txt"):
        a, b = t.find_by_path(path), j.find_by_path(path)
        assert (a and a.path) == (b and b.path)
    assert [m.path for m in t.get_by_rate_range(0.4, 0.6)] == \
        [m.path for m in j.get_by_rate_range(0.4, 0.6)]
    assert t.get_nearest_rate(0.7, "wimax", 576).path == \
        j.get_nearest_rate(0.7, "wimax", 576).path


def test_directory_catalog_matches_jax(tmp_path):
    """A scanned directory: the filename grammar and the ALIST-header
    fallback."""
    a = jgen.gallager_regular(48, 3, 6, seed=11)
    sub = tmp_path / "fam"
    sub.mkdir()
    for fname in ("wimax_576_0.5.alist.txt", "CCSDS_ldpc_n128_k64.alist.txt",
                  "mystery_code.alist.txt", "BCH_7_4_1_strip.alist.txt"):
        jgen.write_alist(a, str(sub / fname))
    t = tcat.MatrixCatalog(str(tmp_path))
    j = jcat.MatrixCatalog(str(tmp_path))
    assert _infos(t) == _infos(j) and len(t) == 4
    t2 = tcat.MatrixCatalog(str(tmp_path), include_builtin=True)
    j2 = jcat.MatrixCatalog(str(tmp_path), include_builtin=True)
    assert _infos(t2) == _infos(j2)
    assert os.path.isfile(t.find_by_path(str(sub / "mystery_code.alist.txt")).path)


@pytest.mark.parametrize("name", ["wimax_576_0.5.alist.txt",
                                  "CCSDS_ldpc_n32_k16.alist.txt"])
@pytest.mark.parametrize("graph", ["orig", "std"])
def test_graph_stats_match_jax(name, graph):
    jc, tc = _codes(name)
    assert tgs.graph_stats(tc, graph=graph) == jgs.graph_stats(jc, graph=graph)


def test_exit_charts_match_jax():
    jc, tc = _codes("wimax_576_0.5.alist.txt")
    np.testing.assert_array_equal(texit.j_function(np.linspace(0, 8, 17)),
                                  jexit.j_function(np.linspace(0, 8, 17)))
    assert texit.edge_degree_distributions(tc.qc) == \
        jexit.edge_degree_distributions(jc.qc)
    assert texit._edges_of(tc.qc) == [(bi, bj) for bi, bj, _ in jc.qc.edges]
    assert texit.exit_threshold(tc.qc, 0.5) == jexit.exit_threshold(jc.qc, 0.5)
    for a, b in zip(texit.exit_curves(tc.qc, 1.0, 0.5),
                    jexit.exit_curves(jc.qc, 1.0, 0.5)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
