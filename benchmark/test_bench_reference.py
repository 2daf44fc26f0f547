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
from benchmark.reference.flooding import FloodingSPA
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


def flooding(c: cells.Cell, two_phase="auto") -> cells.Cell:
    """The configuration of ``c`` decoded by flooding SPA-16 with a check
    every sweep, as the simulator runs it by default: a configuration that
    is no cell."""
    fields = dict(schedule="flooding", iterations=16, two_phase=two_phase)
    c.config["options"].update(fields, check_every=1)
    c.config["decoder"].update(fields, syndrome_check_every=1)
    del c.config["options"]["layer_order"], c.config["decoder"]["layer_order"]
    return c


# configurations that are no cell, each by a name of its own
NO_CELL = {
    "ccsds128-bpsk-1p5db": ccsds128,
    "w1152-bpsk-flood16-2db": lambda: flooding(small("w1152-bpsk-2db")),
    "w1152-bpsk-flood16-split8-2db":
        lambda: flooding(small("w1152-bpsk-2db"), two_phase=8),
    "w1152-bpsk-flood16-sweep": lambda: flooding(small("w1152-bpsk-sweep")),
    "ccsds128-bpsk-flood16-1p5db": lambda: flooding(ccsds128()),
    "w1152-16qam-jam-flood16-5p5db":
        lambda: flooding(small("w1152-16qam-jam-5p5db")),
}

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


@pytest.mark.parametrize("name", CELLS + tuple(NO_CELL))
def test_reference_equals_the_port(name):
    c = NO_CELL[name]() if name in NO_CELL else small(name)
    outs, refs = _port_and_reference(c, Reference(c.config, "cpu"))
    assert outs == refs
    assert sum(p["frame_errors"] for u in refs for p in u) > 0


def test_schedule_is_chosen_in_one_place(tmp_path):
    spec = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = cells._json(cells.ROOT / c["file"])
        sched = cells.schedule(cfg)
        assert sched == (cfg["options"].get("schedule") or "flooding")
        assert sched in cells.SCHEDULES
    assert cells.schedule({"options": {}}) == "flooding"
    assert cells.schedule({"options": {"schedule": None},
                           "decoder": {"schedule": "flooding"}}) == "flooding"
    with pytest.raises(SystemExit, match="'serial-c' is not one of "
                                         "flooding, layered"):
        cells.schedule({"options": {"schedule": "serial-c"}})
    with pytest.raises(SystemExit, match="decoder states schedule 'layered'; "
                                         "its options run 'flooding'"):
        cells.schedule({"options": {}, "decoder": {"schedule": "layered"}})
    # a cell whose schedule has no reference stops when it loads
    c = spec["configs"][0]
    cfg = cells._json(cells.ROOT / c["file"])
    cfg["options"]["schedule"] = cfg["decoder"]["schedule"] = "serial-c"
    (tmp_path / c["file"]).parent.mkdir(parents=True)
    (tmp_path / c["file"]).write_text(json.dumps(cfg))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = next(w["name"] for w in spec["workloads"]
                if w["config"] == c["name"])
    with pytest.raises(SystemExit, match="'serial-c' is not one of"):
        cells.load(cell, root=tmp_path)


def test_default_schedule_is_flooding_on_both_sides():
    """A configuration that names no schedule decodes flooding in the port
    (the simulator's default) and in the reference alike."""
    c = flooding(small("w1152-bpsk-2db"))
    del c.config["options"]["schedule"], c.config["decoder"]["schedule"]
    ref = Reference(c.config, "cpu")
    assert isinstance(ref.decoder, FloodingSPA)
    outs, refs = _port_and_reference(c, ref)
    assert outs == refs
    assert sum(p["frame_errors"] for u in refs for p in u) > 0


@pytest.mark.parametrize("family, n, z, builtin",
                         [PORT_CODES[1], PORT_CODES[3]])
def test_flooding_posteriors_equal_the_port_bit_for_bit(family, n, z,
                                                        builtin):
    """The posteriors after every codeword has stopped, bit for bit: at the
    tests' sizes the counters do not see a posterior summed in another
    order."""
    from ldpc_tpu_torch.ops.decode_loop import DecodeLoop, build_tables
    from ldpc_tpu_torch.sim.runner import load_code

    code = codes.build({"family": family, "rate": "1/2", "n": n,
                        "k": n // 2, "z": z})
    B, sigma = 64, 0.8
    g = torch.Generator().manual_seed(n)
    y = 1.0 + sigma * torch.randn((n, B), generator=g)  # the zero codeword
    ours, port = (2.0 / sigma ** 2) * y, (2.0 / sigma ** 2) * y
    ok, conv = FloodingSPA(code, 16, 1, "cpu").decode(ours)
    loop = DecodeLoop(build_tables(load_code(f"builtin:{builtin}").qc), 16,
                      "spa", check_every=1, schedule="flooding")
    done, conv_port, _ = loop.run(port, torch.zeros(B, dtype=torch.bool))
    assert torch.equal(ours, port)
    assert torch.equal(ok, done) and torch.equal(conv, conv_port)
    assert 0 < int(ok.sum()) < B


def _in_place(dec):
    """Each row writes its posteriors q + E' back during the check phase, so
    later rows read them: a layered update under a flooding label."""
    def check_phase(L, E, live):
        Z, B = dec.Z, L.shape[1]
        for lo, d, idx in dec.rows:
            old, e_old = L[idx], E[lo:lo + d]
            q = old.view(d, Z, B) - e_old
            e_new = dec._check(q)
            L[idx] = torch.where(live, (q + e_new).view(d * Z, B), old)
            E[lo:lo + d] = torch.where(live, e_new, e_old)
    return check_phase


def _without_extrinsic(dec):
    """The check phase reads the posteriors whole, without the ``- E``."""
    def check_phase(L, E, live):
        Z, B = dec.Z, L.shape[1]
        for lo, d, idx in dec.rows:
            E[lo:lo + d] = torch.where(live, dec._check(L[idx].view(d, Z, B)),
                                       E[lo:lo + d])
    return check_phase


@pytest.mark.parametrize("fault", [_in_place, _without_extrinsic])
def test_flooding_fault_differs_from_the_port(fault):
    c = flooding(small("w1152-bpsk-2db"))
    ref = Reference(c.config, "cpu")
    ref.decoder.check_phase = fault(ref.decoder)
    outs, refs = _port_and_reference(c, ref)
    assert check.gaps(outs, refs)["counter_gap"][0] > 0


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
