"""Tanner-graph structure statistics: girth and degree distributions.

A copy of the JAX package's ``analysis/graph_stats.py`` (the port imports
nothing from that package).

Host-side numpy analysis of a code's parity-check graph. Girth is the
standard cycle-structure health check for an LDPC code (4-cycles cripple
BP; the built-in QC generators enforce girth >= 6, models/generate.py) and
pairs with the failure profiler: short-cycle neighborhoods are where the
trapping sets found by the failure profiler
(ldpc_tpu_torch.analysis.failures) live. The reference ships
no graph analysis at all.
"""

from __future__ import annotations

from collections import deque

import numpy as np


def girth(H: np.ndarray, cap: int = 16) -> int | None:
    """Length of the shortest cycle of the Tanner graph of ``H``.

    BFS from every variable node with early abort once a level cannot beat
    the best cycle found (girths are small -- 4/6/8 -- so each BFS touches
    only a few levels). Bipartite graph: the result is even. Returns None
    if no cycle of length <= ``cap`` exists (e.g. a tree).
    """
    H = np.asarray(H)
    m, n = H.shape
    adj: list[list[int]] = [[] for _ in range(n + m)]
    for c, v in zip(*np.nonzero(H)):
        adj[int(v)].append(n + int(c))
        adj[n + int(c)].append(int(v))
    best = cap + 1
    for s in range(n):
        dist = {s: 0}
        par = {s: -1}
        q = deque([s])
        while q:
            u = q.popleft()
            if 2 * dist[u] >= best - 1:
                continue  # deeper levels cannot improve on `best`
            for w in adj[u]:
                if w == par[u]:
                    continue
                if w in dist:  # non-tree edge: cycle through s
                    best = min(best, dist[u] + dist[w] + 1)
                else:
                    dist[w] = dist[u] + 1
                    par[w] = u
                    q.append(w)
    return best if best <= cap else None


def degree_histograms(H: np.ndarray) -> tuple[dict[int, int], dict[int, int]]:
    """Node-perspective degree histograms ``(variable, check)``:
    degree -> node count."""
    H = np.asarray(H) != 0
    vd = H.sum(axis=0)
    cd = H.sum(axis=1)
    var = {int(d): int(c) for d, c in zip(*np.unique(vd, return_counts=True))}
    chk = {int(d): int(c) for d, c in zip(*np.unique(cd, return_counts=True))}
    return var, chk


def graph_stats(code, graph: str = "orig") -> dict:
    """Structure summary of a code's decode graph (JSON-ready).

    ``code`` is an LDPCCode; ``graph`` picks the original sparse H or the
    reference's dense standardized H_std ('std').
    """
    H = (np.asarray(code._h_std_dense) if graph in ("std", "standard")
         else code.H.to_dense())
    var, chk = degree_histograms(H)
    edges = int((np.asarray(H) != 0).sum())
    n, m = code.n, H.shape[0]
    return {
        "graph": "std" if graph in ("std", "standard") else "orig",
        "n": n,
        "m": int(m),
        "k": code.k,
        "rate": code.rate,
        "edges": edges,
        "girth": girth(H),
        "mean_variable_degree": edges / n,
        "mean_check_degree": edges / m,
        "variable_degrees": var,
        "check_degrees": chk,
    }
