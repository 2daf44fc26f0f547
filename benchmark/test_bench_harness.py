"""The harness on the CPU: discovery by name, the import guard, the refusal
without a card, the control and the planted faults (each must turn
``correct`` false), and the trace's reduction.

The runs here skip the look for a card (``run_cell(device="cpu")``) and go
through the rest of a run at small sizes: the port's plain versions stand
for its kernels.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import cells, check, harness, trace
from benchmark.harness import unit_key
from benchmark.reference import codes
from benchmark.reference.sim import Reference
from benchmark.test_bench_reference import CELLS, small

ROOT = cells.ROOT


def _copy_benchmark(dst):
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))


def test_new_files_are_found_by_name(tmp_path):
    _copy_benchmark(tmp_path)
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "w1152-bpsk-layered12.json").read_text())
    cfg["options"]["iterations"] = 16
    (b / "configs" / "w1152-bpsk-flood16.json").write_text(json.dumps(cfg))
    (b / "traffic" / "stream-3db.json").write_text(json.dumps(
        {"kind": "stream", "snr_db": 3.0, "frames_per_call": 8192}))
    (b / "workloads" / "w1152-bpsk-flood16-3db.json").write_text(json.dumps(
        {"units": 1, "limits": {"frames_gap": 0, "counter_gap": 0.5}}))
    (b / "metrics" / "frames_traced.py").write_text(
        "def read(ctx):\n    return ctx.totals()['frames'] or None\n")
    (b / "reference" / "codes" / "dual_diagonal.py").write_text(
        "from benchmark.reference.code import from_blocks\n"
        "def build(code):\n"
        "    return from_blocks([[(1,), (0,), ()], [(), (0,), (0,)]],"
        " code['z'])\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "w1152-bpsk-flood16", "source": "x",
                            "file": "benchmark/configs/w1152-bpsk-flood16.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "w1152-bpsk-flood16-3db",
                              "config": "w1152-bpsk-flood16",
                              "traffic": "stream-3db", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "frames_traced", "unit": "frames",
                              "better": "higher", "source": "program_counter",
                              "layer": "run loop", "moves": "info_bits_per_s",
                              "workloads": ["w1152-bpsk-flood16-3db"]})
    spec["end_to_end"][0]["workloads"].append("w1152-bpsk-flood16-3db")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = cells.load("w1152-bpsk-flood16-3db", root=tmp_path)
    assert c.config["options"]["iterations"] == 16
    assert c.traffic["snr_db"] == 3.0 and c.check["units"] == 1
    assert [m["name"] for m in c.per_layer] == ["frames_traced"]
    assert [m["name"] for m in c.end_to_end] == ["info_bits_per_s", "setup_s"]
    read = cells.reader("frames_traced", root=tmp_path)
    st = trace.Stretch(1.0, 0.5, [], {}, [],
                       units=[[{k: 1 for k in check.COUNTERS}]])
    assert read(harness.Context(c, st, None, "cpu", True, [])) == 1
    here = b / "reference" / "codes"
    assert codes.families(here) == ["ccsds_tc", "dual_diagonal",
                                    "ieee802_16e"]
    qc = codes.build({"family": "dual_diagonal", "n": 12, "k": 4, "z": 4},
                     here)
    assert qc.edges == ((0, 0, 1), (0, 1, 0), (1, 1, 0), (1, 2, 0))
    for p, data in before.items():
        assert p.read_bytes() == data
    assert all(m["name"] != "frames_traced"
               for m in cells.load("w1152-bpsk-2db").per_layer)


def test_split_metric_reads_through_its_base(tmp_path):
    _copy_benchmark(tmp_path)
    m = tmp_path / "benchmark" / "metrics"
    (m / "frames_traced.py").write_text("def read(ctx):\n    return 1\n")
    assert cells.reader("frames_traced.sweep", root=tmp_path)(None) == 1
    (m / "frames_traced.sweep.py").write_text(
        "def read(ctx):\n    return 2\n")
    assert cells.reader("frames_traced.sweep", root=tmp_path)(None) == 2


def test_every_metric_has_a_reader():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        assert callable(cells.reader(m["name"]))
    for w in spec["workloads"]:
        c = cells.load(w["name"])
        assert {m["moves"] for m in c.per_layer} <= \
            {m["name"] for m in c.end_to_end}


def _python(code, cwd, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_the_port_passes_the_import_guard():
    code = ("import ldpc_tpu_torch.sim.runner, ldpc_tpu_torch.analysis.roofline,"
            " benchmark.program, benchmark.harness, benchmark.control\n"
            "from benchmark.run import forbidden_modules\n"
            "assert forbidden_modules() == [], forbidden_modules()\n"
            "import types, sys\n"
            "sys.modules['ldpc_tpu.ops'] = types.ModuleType('ldpc_tpu.ops')\n"
            "assert forbidden_modules() == ['ldpc_tpu'], forbidden_modules()\n"
            "print('ok')")
    r = _python(code, ROOT)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "w1152-bpsk-2db", "--seed", "3000000000", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode not in (0, None) and r.stdout == ""


def test_benchmark_alone_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has
    no program to run: the run raises and prints no result."""
    _copy_benchmark(tmp_path)
    r = _python("from benchmark import cells, harness\n"
                "r = harness.run_cell(cells.load('w1152-bpsk-2db'), 1, 0.1,"
                " False, device='cpu')\nprint(r)", tmp_path)
    assert r.returncode != 0 and r.stdout == ""
    assert "ldpc_tpu_torch" in r.stderr


def _run(name, seconds=0.3):
    return harness.run_cell(small(name), 987654321987, seconds, False,
                            device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] and r["failed"] == 0, r
    assert set(r["metrics"]) == {m["name"] for m in small(name).end_to_end}
    assert r["compared"] == {
        "frames_gap": {"value": 0, "limit": 0},
        "counter_gap": {"value": 0.0,
                        "limit": small(name).check["limits"]["counter_gap"]}}


def _unchanged(self, L, done0):
    """The decode returns its state as it came: the channel's decisions."""
    B = L.shape[1]
    return (done0.clone(), torch.full((B,), -1, dtype=torch.int32),
            torch.full((B,), self.max_iterations, dtype=torch.int32),
            torch.zeros(B))


def _half_batch(self, stats, iters, take):
    from ldpc_tpu_torch.ops.metrics import pack_counters, reduce_block_stats

    valid = torch.arange(*self._rows, device=self.device) < take // 2
    return pack_counters(reduce_block_stats(stats, valid), iters.max())


def _altered(packed):
    def wrapped(self, stats, iters, take):
        out = packed(self, stats, iters, take).clone()
        out[3] = 0  # the batch's answer says that no frame failed
        return out
    return wrapped


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_planted_fault_is_caught(monkeypatch, name, fault):
    from ldpc_tpu_torch.ops.decode_loop import DecodeLoop
    from ldpc_tpu_torch.sim.runner import PointExecutor

    if fault == "unchanged":
        monkeypatch.setattr(DecodeLoop, "decode", _unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(PointExecutor, "packed", _half_batch)
    else:
        monkeypatch.setattr(PointExecutor, "packed",
                            _altered(PointExecutor.packed))
    r = _run(name)
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("name", [c for c in CELLS if "sweep" not in c])
def test_control_fails(name):
    """The reference in bfloat16, put in the program's place, exceeds the
    cell's limit (1024 frames a call here; on the card the control runs at
    the cell's own size through ``benchmark.control``)."""
    c = small(name)
    c.config["options"]["batch"] = 256
    c.traffic["frames_per_call"] = 1024
    keys = [unit_key(1234567, i) for i in range(2)]
    ref = check.reference_units(Reference(c.config, "cpu"), c.traffic, keys)
    ctl = check.reference_units(
        Reference(c.config, "cpu", dtype=torch.bfloat16), c.traffic, keys)
    gap, _ = check.gaps(ctl, ref)["counter_gap"]
    assert gap > c.check["limits"]["counter_gap"]


def test_trace_reduction():
    ev = [("mc_decoder_kernel<8>", True, 1000, 3000),
          ("elementwise_kernel", True, 3000, 3500),
          ("Memcpy DtoH (Device -> Pinned)", True, 6000, 6100),
          ("Memset (Device)", True, 6100, 6150),
          ("aten::mm", False, 3400, 5000),
          ("cudaMemcpyAsync", False, 5800, 6200)]
    st = trace.device_stretch(ev, window_s=1e-5)
    assert st.busy_s == pytest.approx(2650e-9)
    assert [k for k, _ in st.kernels] == ["mc_decoder_kernel<8>",
                                          "elementwise_kernel"]
    assert st.copies == {"DtoH": 1}
    assert st.device_ops[0][0] == "mc_decoder_kernel<8>"
    assert trace.idle_gaps(ev) == [["aten::mm", pytest.approx(2500e-9)]]
