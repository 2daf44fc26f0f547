"""Code construction in the port equals the JAX package's, directly and
through ldpc_tpu_torch.utils.carry.code_from_numpy."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ldpc_tpu.models import standards as jstd
from ldpc_tpu.models.code import LDPCCode as JCode
from ldpc_tpu.models.qc import paired_layer_groups as j_pairs
from ldpc_tpu_torch.models import standards as tstd
from ldpc_tpu_torch.models.code import LDPCCode as TCode
from ldpc_tpu_torch.models.qc import paired_layer_groups as t_pairs
from ldpc_tpu_torch.utils.carry import code_from_numpy

torch.set_num_threads(1)

CODES = [
    "wimax_576_0.5.alist.txt",
    "wimax_1152_0.5.alist.txt",
    "CCSDS_ldpc_n32_k16.alist.txt",
    "LDPC_N336_K196_ITU_G.h.alist.txt",
]


@pytest.mark.parametrize("via", ["builtin", "carry"])
@pytest.mark.parametrize("name", CODES)
def test_code_matches_reference(name, via):
    ref = JCode(alist=jstd.make_builtin(name), name=name)
    if via == "builtin":
        port = TCode(alist=tstd.make_builtin(name), name=name)
    else:
        port = code_from_numpy(ref.n, ref.H.m, ref.H.row_idx, ref.H.col_idx,
                               name)
    assert (port.n, port.m, port.k) == (ref.n, ref.m, ref.k)
    rs, ps = ref.standard_encode_spec, port.standard_encode_spec
    np.testing.assert_array_equal(ps.P, rs.P)
    np.testing.assert_array_equal(ps.map_orig, rs.map_orig)
    np.testing.assert_array_equal(ps.info_pos("orig"), rs.info_pos("orig"))
    assert port.qc.edges == ref.qc.edges
    assert (port.qc.Z, port.qc.nb, port.qc.mb) == (ref.qc.Z, ref.qc.nb, ref.qc.mb)
    assert t_pairs(port.qc) == j_pairs(ref.qc)


def test_richardson_urbanke_is_refused():
    """Refused until the encoder was ported; now the port's spec equals the
    JAX package's (tests/test_torch_models_ru_catalog.py holds more)."""
    code = TCode(alist=tstd.make_builtin(CODES[2]), name=CODES[2])
    ref = JCode(alist=jstd.make_builtin(CODES[2]), name=CODES[2])
    port, want = code.encode_spec("richardson_urbanke"), \
        ref.encode_spec("richardson_urbanke")
    assert port.method == want.method and port.gap == want.gap
    np.testing.assert_array_equal(port.P, want.P)
    np.testing.assert_array_equal(port.map_std, want.map_std)


def test_carry_rejects_bad_indices():
    with pytest.raises(ValueError):
        code_from_numpy(4, 2, [0, 2], [0, 1])
