"""Flooding sum-product decoding of a quasi-cyclic code, plainly.

The channel LLRs X [n, B] (row bj Z + z, one codeword a column, log p0/p1)
are kept; the posteriors L start at X and the check-to-variable messages E
at zero. A sweep has two phases, each over the whole graph:

* the check phase: every slot (bj, s) of every base row reads
  q = L[bj Z + (z + s) % Z] - E from the posteriors of the previous sweep
  and sets E' = 2 atanh(prod over the other slots of tanh(q / 2)), by the
  layered decoder's leave-one-out product and clips
  (:meth:`LayeredSPA._check`);
* the posterior phase: L = X + the sum of every slot's E' that meets the
  variable, each moved back by its shift, added one slot at a time in the
  column-slot order of ``QCCode.col_slots`` (base rows in order, slots in
  row order). Float32 sums do not associate, so the order is part of the
  rule. A row whose slots meet one base column more than once (CCSDS) needs
  nothing more: its slots read the same posteriors and the column sums them
  all.

A codeword stops changing, in E and in L, once it passes the syndrome check
made after every ``check_every`` sweeps; ``conv`` is the last sweep of that
window (0-based), -1 if it never passed within the budget.
"""

from __future__ import annotations

import torch

from benchmark.reference.decoder import LayeredSPA


class FloodingSPA:
    def __init__(self, code, iterations: int, check_every: int, device,
                 dtype=torch.float32):
        # the rows' reads, the syndrome's tables and the check rule are the
        # layered decoder's; only the sweep differs
        rows = LayeredSPA(code, list(range(code.mb)), iterations,
                          check_every, device, dtype)
        self.Z = code.Z
        self.iterations, self.check_every = iterations, check_every
        self._check, self.unsatisfied = rows._check, rows.unsatisfied
        self.rows = [(lo, d, idx) for lo, d, idx, _ in rows.rows]
        self.slots = rows.slots
        first = [lo for lo, _, _ in self.rows]
        z = torch.arange(code.Z, device=device)
        # base column -> its slots (flat slot index, the rows (z - s) % Z
        # that move the slot's message back to the column), in col_slots
        # order
        self.cols = [(bj * code.Z,
                      [(first[bi] + j, (z - s) % code.Z)
                       for bi, j, s in entries])
                     for bj, entries in enumerate(code.col_slots())]

    def check_phase(self, L: torch.Tensor, E: torch.Tensor,
                    live: torch.Tensor) -> None:
        Z, B = self.Z, L.shape[1]
        for lo, d, idx in self.rows:
            e_old = E[lo:lo + d]
            q = L[idx].view(d, Z, B) - e_old
            E[lo:lo + d] = torch.where(live, self._check(q), e_old)

    def posterior_phase(self, L: torch.Tensor, E: torch.Tensor,
                        X: torch.Tensor, live: torch.Tensor) -> None:
        Z = self.Z
        for start, slots in self.cols:
            total = X[start:start + Z]
            for j, back in slots:
                total = total + E[j][back]
            col = L[start:start + Z]
            L[start:start + Z] = torch.where(live, total, col)

    def decode(self, L: torch.Tensor):
        """Decodes in place; returns (ok, conv) per codeword."""
        B = L.shape[1]
        X = L.clone()
        E = torch.zeros((self.slots, self.Z, B), dtype=L.dtype,
                        device=L.device)
        done = torch.zeros(B, dtype=torch.bool, device=L.device)
        conv = torch.full((B,), -1, dtype=torch.int32, device=L.device)
        it = 0
        while it < self.iterations and not bool(done.all()):
            live = ~done
            for _ in range(self.check_every):
                self.check_phase(L, E, live)
                self.posterior_phase(L, E, X, live)
            it += self.check_every
            passed = ~self.unsatisfied(L)
            conv = torch.where(live & passed, it - 1, conv)
            done |= passed
        return done, conv
