"""The benchmark's frozen census equals the program's, on both
configurations (CPU)."""

import numpy as np
import pytest

from benchmark import cells, census
from benchmark.reference.codes.ieee802_16e import wimax

CONFIGS = ("w1152-bpsk-layered12", "w1152-16qam-jam-layered12")


def _port():
    from ldpc_tpu_torch.analysis import roofline
    from ldpc_tpu_torch.sim.runner import load_code

    return roofline, load_code("builtin:wimax_1152_0.5.alist.txt").qc


@pytest.mark.parametrize("name", CONFIGS)
def test_census_equals_the_program(name):
    roofline, qc = _port()
    o = cells._json(cells.HERE / "configs" / f"{name}.json")["options"]
    ours = wimax(1152)
    for layout in (ours, qc):
        for flood in (False, True):
            sched = "flooding" if flood else o["schedule"]
            a = census.decode_census(layout, "spa", sched,
                                     check_every=o["check_every"])
            b = roofline.decode_census(qc, "spa", sched,
                                       check_every=o["check_every"])
            assert a.counts == b.counts
        assert census.channel_census(layout, o["mode"]).counts == \
            roofline.channel_census(qc, o["mode"]).counts
        assert census.counter_census(layout).counts == \
            roofline.counter_census(qc).counts
        assert census.init_census(layout).counts == \
            roofline.init_census(qc).counts


def test_sweeps_and_peaks():
    roofline, _ = _port()
    ok = np.array([True, False, True])
    conv = np.array([3, -1, 11])
    assert np.array_equal(census.lane_sweeps(ok, conv, 12),
                          roofline.lane_sweeps(ok, conv, 12))
    assert census.total_sweeps(3, 2, 14, 12) == \
        int(census.lane_sweeps(ok, conv, 12).sum())
    p = census.peaks("NVIDIA H100 80GB HBM3")
    assert p["ops_per_s"] == roofline.issue_peak_ops_per_s(
        "NVIDIA H100 80GB HBM3", 132, 1980.0)
    assert p["bytes_per_s"] == roofline.HBM_BYTES_PER_S
    assert census.peaks("a card with no published figures here") is None
    assert census.least_time(33.4541e12, 0, "H100")[1] == "operations"
