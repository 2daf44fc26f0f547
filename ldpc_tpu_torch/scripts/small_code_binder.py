"""What binds small codes: a batch ladder and the step with and without K1.

Counterpart of the JAX package's ``scripts/small_code_binder.py`` on one
card, at CCSDS (32, 16) by default, where the fused path spends far more
time a batch than its device work needs. Two experiments:

1. **Batch ladder**: throughput at batch in {4k, 16k, 64k, 256k} with the
   frames per window fixed (``--window-codewords``), through the production
   executor (``PointExecutor.run_point``, a single pass). If a fixed cost
   per batch binds, throughput rises with the batch until it amortizes.
2. **Component isolation** at the production batch (4096, or the window
   where that is smaller): the step
   (``torch.Generator`` info bits -> the encode GEMM -> K1 ``mc_decoder``
   -> ``reduce_block_stats``), and the same step with K1 left out (stats
   derived from the codewords), each looped over a window of
   ``--window-codewords`` frames. Each window is timed twice: by the host's
   clock, ending in the host fetch of the counters (host us a step), and
   by CUDA events around the same launches, 8 steps at a time, each 8
   queued behind a spin kernel that outlasts their enqueue (device us a
   step, with no wait on the host in it). One minus their ratio is the
   device's idle share. The device's time holds only where the host
   queued every 8 steps before their spin ended
   (``queued_before_spin_ended``); where it did not, the host's gaps would
   count as device time, so the device's numbers are left out and
   :func:`main` returns 1.

Writes ``<out>/binder.json`` (default ``build/sublane_fill``), with the
JAX script's keys; ``step_ops_us_per_batch`` is the JAX record's
``xla_us_per_batch`` (nothing here is XLA).

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.small_code_binder``
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

_M32 = 0xFFFFFFFF
QUEUE_STEPS = 8  # steps queued behind one spin: a few hundred launches
ISOLATION_BATCH = 4096  # the production batch


def ladder_point(code, batch: int, snr: float, window: int, rounds: int,
                 device=None) -> dict:
    """Median-window throughput of ``run_point`` at one batch size."""
    from ldpc_tpu_torch.sim.config import SimOptions
    from ldpc_tpu_torch.sim.runner import PointExecutor, derive_key

    opts = SimOptions(
        matrix=code.name, blocks=batch, iterations=12, ber=True,
        fer=True, fidelity="exact", batch=batch, seed=0,
        speed=code.k / code.n, schedule="layered", layer_order="paired",
        check_every=2, two_phase="off", quiet=True, sublane_groups=1,
    )
    ex = PointExecutor(code, opts, device=device)
    ex.run_point(snr, window, 99, 0)  # warm-up
    times = []
    for r in range(rounds):
        t0 = time.perf_counter()
        ex.run_point(snr, window, derive_key(0, r), r)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    return {"median_s": med, "info_bits_per_s": window * code.k / med,
            "per_batch_ms": 1e3 * med / (window / batch), "times": times,
            "kernel": ex.kernel_used}


class Isolation:
    """The fused step at one batch size, with and without K1, on one
    device: ``window(key, with_kernel)`` enqueues ``n_steps`` steps and
    returns their summed counters (device tensors, not fetched)."""

    def __init__(self, code, snr: float, batch: int, n_steps: int, device):
        from ldpc_tpu_torch.ops.channel import ChannelParams
        from ldpc_tpu_torch.ops.encode import make_encoder_T
        from ldpc_tpu_torch.ops.mc_kernels import MCDecoder

        spec = code.standard_encode_spec
        self.code, self.batch, self.n_steps = code, batch, n_steps
        self.device = device
        self.encode_T = make_encoder_T(spec, "orig", device)
        self.consts = ChannelParams(mode=1, snr_db=snr, speed=code.k / code.n,
                                    noise_model="exact").consts(device)
        self.mc = MCDecoder(code.qc, spec.info_pos("orig"), 12, "spa",
                            schedule="layered", check_every=2)
        import torch

        self.valid = torch.ones(batch, dtype=torch.bool, device=device)

    def step(self, key: int, with_kernel: bool):
        import torch

        from ldpc_tpu_torch.ops.encode import random_info_bits
        from ldpc_tpu_torch.ops.metrics import BlockStats, reduce_block_stats
        from ldpc_tpu_torch.scripts.study import generator
        from ldpc_tpu_torch.sim.runner import derive_key

        u = random_info_bits(generator(derive_key(key, 0), self.device),
                             self.batch, self.code.k)
        wT = self.encode_T(u)
        kn = derive_key(key, 1)
        seeds = (kn & _M32, kn >> 32)
        if with_kernel:
            err, ok, conv, norm, _ = self.mc(wT, self.consts, seeds=seeds)
            stats = BlockStats(error_bits=err, ok=ok, conv_iter=conv,
                               norm_llr=norm)
        else:
            # everything but the decode: stats derived from the codewords
            col = wT[0].to(torch.int32)
            stats = BlockStats(error_bits=col, ok=col > 0, conv_iter=col,
                               norm_llr=wT[1])
        return reduce_block_stats(stats, self.valid)

    def window(self, key0: int, with_kernel: bool, steps=None):
        """The summed counters of steps ``steps`` (default: all) of the
        window at ``key0``."""
        from ldpc_tpu_torch.sim.runner import derive_key

        tot = None
        for j in steps if steps is not None else range(self.n_steps):
            c = self.step(derive_key(key0, j), with_kernel)
            tot = c if tot is None else tot + c
        return tot

    def time(self, with_kernel: bool, rounds: int) -> dict:
        """Median host seconds a window (ending in the host fetch) and, on
        the card, median device seconds a window: CUDA events around each
        :data:`QUEUE_STEPS` steps of it, queued behind a spin kernel that
        outlasts their enqueue, summed."""
        from ldpc_tpu_torch.sim.runner import derive_key

        int(self.window(1, with_kernel).blocks)  # warm
        host = []
        for r in range(rounds):
            t0 = time.perf_counter()
            int(self.window(derive_key(2, r), with_kernel).blocks)
            host.append(time.perf_counter() - t0)
        out = {"host_s": float(np.median(host)), "host_times": host}
        if self.device.type != "cuda":
            return out
        import torch

        ms_per_cycle = _spin_ms_per_cycle()
        # the host queues QUEUE_STEPS steps in well under this
        spin_ms = 3e3 * max(host) * QUEUE_STEPS / self.n_steps + 5.0
        dev_t, queued = [], []
        for r in range(rounds):
            total = 0.0
            for j0 in range(0, self.n_steps, QUEUE_STEPS):
                torch.cuda.synchronize()
                torch.cuda._sleep(int(spin_ms / ms_per_cycle))
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                tot = self.window(derive_key(2, r), with_kernel,
                                  range(j0, min(j0 + QUEUE_STEPS,
                                                self.n_steps)))
                e1.record()
                queued.append(1e3 * (time.perf_counter() - t0) < spin_ms)
                e1.synchronize()
                int(tot.blocks)
                total += e0.elapsed_time(e1) / 1e3
            dev_t.append(total)
        out.update(device_s=float(np.median(dev_t)), device_times=dev_t,
                   queued_before_spin_ended=all(queued))
        return out


def _spin_ms_per_cycle() -> float:
    """Milliseconds a cycle of ``torch.cuda._sleep`` takes on the card."""
    import torch

    cycles = 10_000_000
    torch.cuda._sleep(cycles)  # warm
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda._sleep(cycles)
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / cycles


def isolation(code, snr: float, batch: int, n_steps: int, rounds: int,
              device) -> dict:
    """The component isolation's record (the JAX keys, plus the host's and,
    where every group of steps was queued before its spin ended, the
    device's time a step)."""
    iso = Isolation(code, snr, batch, n_steps, device)
    full = iso.time(True, rounds)
    nok = iso.time(False, rounds)
    t_full, t_nok = full["host_s"], nok["host_s"]
    rec = {
        "n_steps": n_steps, "batch": batch,
        "full_s": t_full, "no_kernel_s": t_nok,
        "kernel_s": t_full - t_nok,
        "kernel_us_per_batch": (t_full - t_nok) / n_steps * 1e6,
        "step_ops_us_per_batch": t_nok / n_steps * 1e6,
        "host_us_per_step": t_full / n_steps * 1e6,
        "full": full, "no_kernel": nok,
    }
    if "device_s" in full:
        rec["queued_before_spin_ended"] = (full["queued_before_spin_ended"]
                                           and nok["queued_before_spin_ended"])
    if rec.get("queued_before_spin_ended"):
        d_full, d_nok = full["device_s"], nok["device_s"]
        rec.update(
            device_us_per_step=d_full / n_steps * 1e6,
            device_us_per_step_no_kernel=d_nok / n_steps * 1e6,
            kernel_device_us_per_batch=(d_full - d_nok) / n_steps * 1e6,
            device_idle_share=1.0 - d_full / t_full,
        )
    return rec


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--code", default="CCSDS_ldpc_n32_k16.alist.txt")
    ap.add_argument("--snr", type=float, default=5.65)
    ap.add_argument("--out", default="build/sublane_fill")
    ap.add_argument("--window-codewords", type=int, default=64 * 4096)
    ap.add_argument("--batches", default="4096,16384,65536,262144")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)

    from ldpc_tpu_torch.utils.cache import enable_compile_cache

    enable_compile_cache()

    from ldpc_tpu_torch.scripts.study import device_label
    from ldpc_tpu_torch.sim.runner import load_code
    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    label = device_label(dev)
    code = load_code(f"builtin:{args.code}")
    print(f"# device={label} code={code.name} n={code.n} k={code.k} "
          f"Z={code.qc.Z}", flush=True)

    W = args.window_codewords
    result = {"device": label, "code": code.name, "snr_db": args.snr,
              "window_codewords": W, "ladder": {}}
    for batch in (int(b) for b in args.batches.split(",")):
        p = ladder_point(code, batch, args.snr, W, args.rounds, dev)
        result["ladder"][str(batch)] = p
        print(f"batch={batch:>7d}: {p['info_bits_per_s'] / 1e9:6.3f} G bits/s "
              f"({p['per_batch_ms']:6.2f} ms/batch, {W // batch} "
              f"steps/window, {p['kernel']})", flush=True)

    batch = min(ISOLATION_BATCH, W)
    iso = isolation(code, args.snr, batch, W // batch, args.rounds, dev)
    result["isolation"] = iso
    print(f"# attribution (host clock): K1 {iso['kernel_us_per_batch']:.0f} "
          f"us/batch, step ops {iso['step_ops_us_per_batch']:.0f} us/batch; "
          f"host {iso['host_us_per_step']:.1f} us a step", flush=True)
    if "device_us_per_step" in iso:
        print(f"# device (CUDA events, queue filled): "
              f"{iso['device_us_per_step']:.1f} us a step, "
              f"{iso['device_us_per_step_no_kernel']:.1f} without K1, K1 "
              f"{iso['kernel_device_us_per_batch']:.1f} us; idle share "
              f"{100 * iso['device_idle_share']:.1f}%", flush=True)
    elif "queued_before_spin_ended" in iso:
        print("# device time not measured: the host did not queue every "
              f"{QUEUE_STEPS} steps before their spin ended", flush=True)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "binder.json").write_text(json.dumps(result, indent=1))
    print(f"# wrote {out}/binder.json", flush=True)
    return 0 if iso.get("queued_before_spin_ended", True) else 1


if __name__ == "__main__":
    raise SystemExit(main())
