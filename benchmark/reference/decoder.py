"""Layered sum-product decoding of a quasi-cyclic code, plainly.

The posteriors L [n, B] (row bj Z + z, one codeword a column, log p0/p1)
start at the channel LLRs and the check-to-variable messages E at zero. A
sweep visits the base rows in the schedule's order; a row with slots
(bj, s) reads q = L[bj Z + (z + s) % Z] - E, sets
E' = 2 atanh(prod over the other slots of tanh(q / 2)) and writes q + E' back.
A row whose slots meet one base column more than once (a block that is a
sum of circulants, as in the CCSDS codes) reads every q from the posteriors
as they stood before the row, and then adds to each of its base columns, once,
the sum of its slots' changes E' - E, each moved back by its shift, in slot
order.
A codeword stops changing once it passes the syndrome check made after
every ``check_every`` sweeps; ``conv`` is the last sweep of that window
(0-based), -1 if it never passed within the budget. The leave-one-out
product folds the slots before (left to right) and after (right to left),
with tanh's input clipped to +-17.5 and the product to the largest value
below 1 of the arithmetic's type.
"""

from __future__ import annotations

from functools import reduce

import torch

TANH_CLIP = 17.5


class LayeredSPA:
    def __init__(self, code, order: list[int], iterations: int,
                 check_every: int, device, dtype=torch.float32):
        Z = code.Z
        self.Z, self.n, self.mb = Z, code.n, code.mb
        self.order = order
        self.iterations = iterations
        self.check_every = check_every
        self.dtype = dtype
        self.clip = 1.0 - torch.finfo(dtype).eps / 2
        z = torch.arange(Z, device=device)
        self.rows, self.slots = [], 0
        var, chk = [], []
        for bi, slots in enumerate(code.row_slots()):
            idx = torch.cat([bj * Z + (z + s) % Z for bj, s in slots])
            # base column -> its slots j, each with the rows (z - s) % Z that
            # move a change of slot j back to the column's rows
            cols: dict[int, list] = {}
            for j, (bj, s) in enumerate(slots):
                cols.setdefault(bj * Z, []).append((j, (z - s) % Z))
            self.rows.append((self.slots, len(slots), idx,
                              None if len(cols) == len(slots)
                              else list(cols.items())))
            self.slots += len(slots)
            var.append(idx)
            chk.append((bi * Z + z).repeat(len(slots)))
        self.var, self.chk = torch.cat(var), torch.cat(chk)

    def _check(self, q: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(torch.tanh(torch.clamp(q * 0.5, -TANH_CLIP, TANH_CLIP)),
                        -self.clip, self.clip)
        d = t.shape[0]
        before, after = [None] * d, [None] * d
        for i in range(1, d):
            before[i] = t[0] if i == 1 else before[i - 1] * t[i - 1]
            j = d - 1 - i
            after[j] = t[d - 1] if i == 1 else after[j + 1] * t[j + 1]
        prods = []
        for b, a in zip(before, after):
            prods.append(a if b is None else b if a is None else b * a)
        p = torch.clamp(torch.stack(prods), -self.clip, self.clip)
        return torch.log((1.0 + p) / (1.0 - p))

    def unsatisfied(self, L: torch.Tensor) -> torch.Tensor:
        bits = (L[self.var] < 0).to(torch.int32)
        par = torch.zeros((self.mb * self.Z, L.shape[1]), dtype=torch.int32,
                          device=L.device)
        par.index_add_(0, self.chk, bits)
        return (par & 1).any(dim=0)

    def decode(self, L: torch.Tensor):
        """Decodes in place; returns (ok, conv) per codeword."""
        Z, B = self.Z, L.shape[1]
        E = torch.zeros((self.slots, Z, B), dtype=L.dtype, device=L.device)
        done = torch.zeros(B, dtype=torch.bool, device=L.device)
        conv = torch.full((B,), -1, dtype=torch.int32, device=L.device)
        it = 0
        while it < self.iterations and not bool(done.all()):
            live = ~done
            for _ in range(self.check_every):
                for bi in self.order:
                    lo, d, idx, cols = self.rows[bi]
                    old = L[idx]
                    e_old = E[lo:lo + d]
                    q = old.view(d, Z, B) - e_old
                    e_new = self._check(q)
                    if cols is None:
                        L[idx] = torch.where(live, (q + e_new).view(d * Z, B),
                                             old)
                    else:
                        change = e_new - e_old
                        for start, js in cols:
                            total = reduce(torch.add, (change[j][back]
                                                       for j, back in js))
                            col = L[start:start + Z]
                            L[start:start + Z] = torch.where(live, col + total,
                                                             col)
                    E[lo:lo + d] = torch.where(live, e_new, e_old)
            it += self.check_every
            passed = ~self.unsatisfied(L)
            conv = torch.where(live & passed, it - 1, conv)
            done |= passed
        return done, conv
