"""Exact-noise replay parity for channel mode 3 (barrage jamming).

Counterpart of the JAX package's ``scripts/parity_fixed_noise.py``. With
``--threads 1`` the reference creates its Channel ONCE per SNR point and the
two Park-Miller LCGs (IDUM1/IDUM2) advance continuously across blocks, so
the ENTIRE noise sequence of a B-block mode-3 run is deterministic: block b
consumes Box-Muller calls [b*n, (b+1)*n) of each stream, with the cos/sin
branch picked by the bit index within the block. The only randomness in the
reference run is the data bits.

This script replays that exact noise sequence with ``utils.legacy_rng``
(bit-exact LCG + Box-Muller, sequential host code, timed per point), decodes
``--reps`` random codewords against EVERY one of the B fixed noise rows with
the reference-fidelity plain decoder (H_std graph, legacy check rule), and
reports E[FER], E[BER | failed-frames accounting] conditioned on the
reference's own noise realization. The reference run is read from
``parity_runs/ref_mode3.json`` (an input); the result goes to ``--out``
(default ``build/parity_runs/fixed_noise.json``).

Usage (GPU): ``python -m ldpc_tpu_torch.scripts.parity_fixed_noise
[--reps 100]``
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np

REF_RUN = "parity_runs/ref_mode3.json"  # the reference's mode-3 run


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=100,
                    help="random codewords per fixed noise row")
    ap.add_argument("--out", default="build/parity_runs/fixed_noise.json")
    return ap


def replay_noise(prm, blocks: int, n: int) -> np.ndarray:
    """The reference's mode-3 noise rows [blocks, n] (float64, LLR units):
    both Park-Miller streams run continuously across the blocks (call index
    b*n + i, branch parity i % 2; n is even so the pattern aligns)."""
    from ldpc_tpu_torch.utils.legacy_rng import IDUM1, IDUM2, ParkMillerGauss

    g1 = ParkMillerGauss(IDUM1, prm.sigma1)
    g2 = ParkMillerGauss(IDUM2, prm.sigma2)
    n1 = g1.gauss_sequence(blocks * n).reshape(blocks, n)
    n2 = g2.gauss_sequence(blocks * n).reshape(blocks, n)
    return (n1 + prm.p * n2) * prm.l_c3


def main(argv=None, device=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from ldpc_tpu_torch.models.code import LDPCCode
    from ldpc_tpu_torch.models.standards import wimax
    from ldpc_tpu_torch.ops.channel import ChannelParams
    from ldpc_tpu_torch.ops.encode import make_encoder, random_info_bits
    from ldpc_tpu_torch.ops.spa import make_decoder
    from ldpc_tpu_torch.scripts.study import device_label, generator
    from ldpc_tpu_torch.sim.runner import derive_key
    from ldpc_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    code = LDPCCode(alist=wimax(576, "1/2"), name="wimax_576_0.5")
    n, k = code.n, code.k
    spec = code.standard_encode_spec
    info_pos = np.asarray(spec.info_pos("std"))
    info_t = torch.as_tensor(info_pos, dtype=torch.int64, device=dev)
    encode = make_encoder(spec, "std", dev)
    dec = make_decoder(code.layout("std"), info_pos, 5, "spa",
                       rule="legacy", device=dev)
    print(f"# device={device_label(dev)}", flush=True)

    ref3 = json.loads(Path(REF_RUN).read_text())
    B = ref3["config"]["blocks"]
    R = args.reps
    results = []
    for pt in ref3["snr_points"]:
        snr = pt["snr_db"]
        prm = ChannelParams(mode=3, snr_db=snr, speed=1.0,
                            interference_snr_db=6.0, p=0.1)
        t0 = time.perf_counter()
        noise_np = replay_noise(prm, B, n)
        secs = time.perf_counter() - t0
        print(f"# Park-Miller noise at {snr:g} dB: {2 * B * n} Box-Muller "
              f"draws on the host in {secs:.3f} s", flush=True)
        noise = torch.as_tensor(noise_np.astype(np.float32), device=dev)
        l_c3 = float(np.float32(prm.l_c3))

        fer_num = 0
        err_bits = 0
        for rep in range(R):
            u = random_info_bits(generator(derive_key(123, rep), dev), B, k)
            sym = 2.0 * encode(u) - 1.0
            r = dec(sym * l_c3 + noise)
            ok = r.ok
            u_hat = r.est.index_select(1, info_t)
            fer_num += int((~ok).sum())
            err_bits += int(((u_hat != u.to(u_hat.dtype))
                             & ~ok[:, None]).sum())
        fer = fer_num / (B * R)
        ber = err_bits / (B * R * k)
        # residual comparison error: the reference's info-bit sampling only,
        # approximated by the binomial SE of its B-block FER estimate
        se = math.sqrt(max(fer * (1 - fer), 1e-12) / B)
        z = (pt["fer"] - fer) / max(se, 1e-9)
        results.append({"snr_db": snr, "ref_fer": pt["fer"],
                        "ref_ber": pt["ber"], "fer": fer, "ber": ber,
                        "z_fer": z, "reps": R, "blocks": B})
        print(f"mode3 snr={snr:4.1f}: ref FER {pt['fer']:.4g} BER "
              f"{pt['ber']:.5g} | exact-noise replay FER {fer:.4g} BER "
              f"{ber:.5g} (z_FER={z:+.2f})", flush=True)

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
