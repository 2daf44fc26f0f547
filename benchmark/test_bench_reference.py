"""The plain reference against the port, on the CPU at small sizes.

Run from the checkout's root: ``python -m pytest benchmark/ -q``. Only the
tests import the port; the reference takes nothing from it.
"""

import json

import numpy as np
import pytest
import torch

from benchmark import cells, check
from benchmark.harness import unit_key
from benchmark.reference import channel, codes, rng
from benchmark.reference.codes.ieee802_16e import wimax
from benchmark.reference.sim import Reference

# several test processes share the host: one or two threads each
torch.set_num_threads(min(2, torch.get_num_threads()))

CELLS = ("w1152-bpsk-2db", "w1152-16qam-jam-5p5db", "w1152-bpsk-sweep",
         "w1152-bpsk-1db")


def small(name: str) -> cells.Cell:
    """The cell at a batch of 64: 256 frames a call, 512 a sweep point with
    an error target of 5 (the fused path forced on, so that the CPU stops a
    point on the card's schedule)."""
    c = cells.load(name)
    c.config["options"]["batch"] = 64
    if c.traffic["kind"] == "stream":
        c.traffic["frames_per_call"] = 256
    else:
        c.traffic.update(frames_per_point=512, target_errors=5)
        c.config["options"]["fused"] = "on"
    return c


def ccsds128() -> cells.Cell:
    """A configuration that is no cell: the CCSDS (128, 64) TC code, whose
    rows each meet one base column twice, on the fused path (layered SPA-12,
    ``two_phase`` ``auto``) at a batch of 64, 256 frames a call at 1.5 dB,
    where such short frames fail often."""
    c = small("w1152-bpsk-2db")
    c.name = "ccsds128-bpsk-1p5db"
    c.config["code"] = {"family": "ccsds_tc", "rate": "1/2",
                        "n": 128, "k": 64, "z": 16}
    c.config["options"]["matrix"] = "builtin:CCSDS_ldpc_n128_k64.alist.txt"
    c.traffic["snr_db"] = 1.5
    return c


# (family, n, Z, the port's built-in of that code)
PORT_CODES = [("ieee802_16e", n, n // 24, f"wimax_{n}_0.5.alist.txt")
              for n in (576, 1152, 2304)] + \
    [("ccsds_tc", n, n // 8, f"CCSDS_ldpc_n{n}_k{n // 2}.alist.txt")
     for n in (128, 256, 512)]


@pytest.mark.parametrize("family, n, z, builtin", PORT_CODES)
def test_code_matches_the_port(family, n, z, builtin):
    from ldpc_tpu_torch.models.qc import paired_layer_groups
    from ldpc_tpu_torch.sim.runner import load_code

    ours = codes.build({"family": family, "rate": "1/2", "n": n,
                        "k": n // 2, "z": z})
    port = load_code(f"builtin:{builtin}")
    assert np.array_equal(ours.dense(), port.H.to_dense())
    info, _, _ = ours.systematic
    spec = port.encode_spec("standard")
    assert np.array_equal(info, spec.info_pos("orig"))
    u = np.random.default_rng(n).integers(0, 2, (8, ours.k), dtype=np.uint8)
    w = (u.astype(np.int64) @ ours.generator().astype(np.int64)) & 1
    assert np.array_equal(w, spec.encode_numpy(u, "orig"))
    assert not ((ours.dense().astype(np.int64) @ w.T) & 1).any()
    assert ours.paired_order() == [bi for g in paired_layer_groups(port.qc)
                                   for bi in g]


def test_every_configuration_loads_its_family():
    spec = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:  # each stops unless it builds its n, k, z
        codes.build(cells._json(cells.ROOT / c["file"])["code"])
    with pytest.raises(SystemExit, match="'turbo' is not one of "
                                         "ccsds_tc, ieee802_16e"):
        codes.build({"family": "turbo", "n": 128, "k": 64, "z": 16})
    with pytest.raises(SystemExit, match="None is not one of"):
        codes.build({"n": 1152, "k": 576, "z": 48})
    with pytest.raises(SystemExit, match=r"built \(n, k, z\) = \(120, 60, 5\); "
                                         r"the configuration states "
                                         r"\(128, 64, 16\)"):
        codes.build({"family": "ieee802_16e", "rate": "1/2", "n": 128,
                     "k": 64, "z": 16})


@pytest.mark.parametrize("snr, isnr, p", [(2.0, 1.0, 0.1), (5.5, -3.0, 0.15)])
def test_constants_match_the_port(snr, isnr, p):
    from ldpc_tpu_torch.ops.channel import CONSTS_ORDER, ChannelParams

    c = channel.constants(snr, 0.5, isnr_db=isnr, p=p)
    port = ChannelParams(mode=2, modulation=16, speed=0.5, snr_db=snr,
                         interference_snr_db=isnr, p=p,
                         noise_model="exact").consts("cpu")
    v = dict(zip(CONSTS_ORDER, port.tolist()))
    assert c["noise_std"] == v["noise1_std"] == c["sigma1"] == v["sigma1"]
    for name in ("llr_scale", "sigma2", "p"):
        assert c[name] == v[name]


def test_philox_normals_match_the_port():
    from ldpc_tpu_torch.ops.mc_kernels import channel_llr_reference, philox_raw

    code, B = wimax(1152), 32
    key = rng.fused_streams(unit_key(7, 3), "cpu")[1]
    z = rng.normals(key, code.nb, code.Z, B, "cpu").view(code.n, B)
    raw = philox_raw(key, code.n, code.Z, B, 1, "cpu")
    consts = torch.tensor([1.0, 1.0, 0, 0, 0, 0, 0, 0])
    zero = torch.full((code.n, B), 0.5)  # sym 0: the LLR is the noise
    assert torch.equal(channel_llr_reference(zero, raw, consts, 1, 1, code.Z),
                       z)


def _port_and_reference(c: cells.Cell, ref: Reference):
    """The port's counters on the CPU and the reference's, of two units."""
    from benchmark.program import Program

    prog = Program(c.config, c.traffic, "cpu")
    prog.start()
    keys = [unit_key(20240229, i) for i in range(2)]
    unit = prog.call if c.traffic["kind"] == "stream" else prog.sweep
    outs = [unit(k) for k in keys]
    outs = [[o] if isinstance(o, dict) else o for o in outs]
    return outs, check.reference_units(ref, c.traffic, keys)


@pytest.mark.parametrize("name", CELLS + ("ccsds128-bpsk-1p5db",))
def test_reference_equals_the_port(name):
    c = ccsds128() if name == "ccsds128-bpsk-1p5db" else small(name)
    outs, refs = _port_and_reference(c, Reference(c.config, "cpu"))
    assert outs == refs
    assert sum(p["frame_errors"] for u in refs for p in u) > 0


def test_last_write_wins_differs_from_the_port():
    """The update that treats a row meeting one base column twice as any
    other row, each slot writing q + E' in turn (the second write drops the
    first slot's change), does not give the port's counters."""
    c = ccsds128()
    ref = Reference(c.config, "cpu")
    assert all(cols is not None for *_, cols in ref.decoder.rows)
    ref.decoder.rows = [(lo, d, idx, None)
                        for lo, d, idx, _ in ref.decoder.rows]
    outs, refs = _port_and_reference(c, ref)
    assert check.gaps(outs, refs)["counter_gap"][0] > 0


def test_sweep_stops_on_the_schedule():
    """A point's frames follow the probe, groups of 8/4/2, then singles."""
    c = small("w1152-bpsk-sweep")
    ref = Reference(c.config, "cpu")
    pts = check.reference_units(ref, c.traffic, [unit_key(5, 0)])[0]
    assert [p["frames"] % 64 for p in pts] == [0] * len(pts)
    assert pts[-1]["frames"] == 512  # the high end never meets the target
    assert check.snr_grid(1.0, 3.0, 0.5) == [1.0, 1.5, 2.0, 2.5, 3.0]
