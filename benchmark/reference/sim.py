"""The counters a Monte-Carlo call or sweep should give, worked out again.

A batch's counters: ``frames``; ``frame_errors``, the codewords that never
passed the syndrome check; ``bit_errors``, the wrong info bits of those
codewords only (hard decision L < 0 read as bit 1); ``converged`` and
``conv_sum``, the count and the sum of ``conv`` over codewords that passed.

A call of F frames runs F / batch batches of the point's key tree. A sweep
point under an error target stops on the simulator's schedule: one probe
batch first where the split is decided at run time, then, while two or more
batches remain and the target is not met, the largest power of two of at
most 8 batches that fits, and then single batches; the errors are read
after each such group.
"""

from __future__ import annotations

import torch

from benchmark.cells import schedule
from benchmark.reference import channel, codes, rng
from benchmark.reference.decoder import LayeredSPA
from benchmark.reference.flooding import FloodingSPA

COUNTERS = ("frames", "frame_errors", "bit_errors", "converged", "conv_sum")
# batches decoded together: 16 x 4096 frames of WiMAX 1152 fit the card
BATCHES_PER_BLOCK = 16


class Reference:
    """One configuration's reference on one device. ``dtype`` is the
    arithmetic of the channel and the decoder (the configuration states
    float32)."""

    def __init__(self, config: dict, device, dtype=torch.float32):
        o = config["options"]
        self.o = o
        self.device = torch.device(device)
        self.dtype = dtype
        self.code = codes.build(config["code"])
        self.batch = o["batch"]
        info, _, _ = self.code.systematic
        self.info = torch.as_tensor(info, device=self.device)
        self.G = torch.as_tensor(self.code.generator(), device=self.device)
        every = o.get("check_every", 1)
        if schedule(config) == "flooding":
            self.decoder = FloodingSPA(self.code, o["iterations"], every,
                                       self.device, dtype)
        else:
            order = (self.code.paired_order()
                     if o.get("layer_order") == "paired"
                     else list(range(self.code.mb)))
            self.decoder = LayeredSPA(self.code, order, o["iterations"],
                                      every, self.device, dtype)
        self.fused = o.get("modulation", 1) == 1 and \
            o.get("interleaver", "none") == "none"
        # the split is decided by a probe batch at each point's start
        self.probe = self.fused and o.get("two_phase", "auto") == "auto" \
            and o["iterations"] >= 8

    def consts(self, snr_db: float) -> dict:
        o = self.o
        return channel.constants(snr_db, o["speed"],
                                 isnr_db=o.get("interference_snr", 1.0),
                                 p=o.get("p", 0.1))

    def _llrs(self, key: int, c: dict):
        """(info bits [B, k], codewords [n, B], decoder LLRs [n, B])."""
        dev, B, k = self.device, self.batch, self.code.k
        if self.fused:
            gen, pkey = rng.fused_streams(key, dev)
            u = rng.info_bits(gen, B, k)
            wT = torch.remainder(self.G.T @ u.to(torch.float32).T, 2.0)
            z = rng.normals(pkey, self.code.nb, self.code.Z, B, dev,
                            self.dtype).view(self.code.n, B)
            return u, wT, channel.bpsk_llr(wT.to(self.dtype), z, c)
        u = rng.info_bits(rng.generator(rng.derive(key, 0) >> 1, dev), B, k)
        w, L = channel.unfused_llr(u, self.G, key, c, self.dtype)
        return u, w.T, L

    def batches(self, point_key: int, snr_db: float, first: int, count: int):
        """Counter rows [count, 5] (int64, in COUNTERS order) of batches
        ``first .. first + count - 1`` of a point."""
        c = self.consts(snr_db)
        rows = []
        end = first + count
        for b0 in range(first, end, BATCHES_PER_BLOCK):
            parts = [self._llrs(rng.derive(point_key, i), c)
                     for i in range(b0, min(b0 + BATCHES_PER_BLOCK, end))]
            wT = torch.cat([p[1] for p in parts], dim=1)
            L = torch.cat([p[2] for p in parts], dim=1)
            del parts
            ok, conv = self.decoder.decode(L)
            wrong = ((L[self.info] < 0) != (wT[self.info] != 0)).sum(dim=0)
            wrong = torch.where(ok, 0, wrong)
            passed = conv >= 0
            per = torch.stack([
                torch.ones_like(wrong), ~ok, wrong, passed,
                torch.where(passed, conv, 0)], dim=1).to(torch.int64)
            rows.append(per.view(-1, self.batch, 5).sum(dim=1))
            del L, wT
        return torch.cat(rows).cpu()

    def call(self, base_key: int, snr_db: float, frames: int) -> dict:
        """The counters of one call of ``frames`` frames at point 0."""
        nb = -(-frames // self.batch)
        tot = self.batches(rng.derive(base_key, 0), snr_db, 0, nb).sum(dim=0)
        return dict(zip(COUNTERS, (int(x) for x in tot)))

    def point(self, base_key: int, index: int, snr_db: float, frames: int,
              target: int) -> dict:
        """The counters of sweep point ``index`` under an error target."""
        key = rng.derive(base_key, index)
        nb = -(-frames // self.batch)
        tot = torch.zeros(5, dtype=torch.int64)
        done = 0

        def run(count):
            nonlocal tot, done
            tot = tot + self.batches(key, snr_db, done, count).sum(dim=0)
            done += count

        if self.probe:
            run(1)
        if not target:
            run(nb - done)
        else:
            while nb - done >= 2 and tot[1] < target:
                group = min(nb - done, 8)
                run(1 << (group.bit_length() - 1))
            while nb - done > 0 and tot[1] < target:
                run(1)
        return dict(zip(COUNTERS, (int(x) for x in tot)))
