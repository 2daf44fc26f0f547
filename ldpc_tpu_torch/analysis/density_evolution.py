"""Monte-Carlo protograph density evolution on the AWGN channel.

Counterpart of ``ldpc_tpu/analysis/density_evolution.py``. Estimates the
asymptotic (infinite-blocklength, cycle-free) decoding threshold of a
protograph LDPC ensemble: the lowest Eb/N0 at which belief propagation
drives the error probability to zero. The base graphs that define the
built-in QC codes (ldpc_tpu_torch.models.standards / .qc) feed the
estimator directly.

Method (sampled DE, one LLR population per directed base edge):

  * all-zero codeword, BPSK over AWGN: channel LLRs (log(p0/p1) domain)
    m0 ~ N(2/sigma^2, 4/sigma^2).
  * variable update for base edge e=(c,v):
        M_e = m0_v + sum_{e' at v, e' != e} E_{e'}
  * check update: E_e = 2 atanh( prod_{e' at c, e' != e} tanh(M_{e'}/2) )
  * populations are independently resampled between updates (the
    cycle-free assumption); error probability = fraction of negative
    posteriors.

The samples come from an explicit ``torch.Generator`` seeded by ``seed``,
so a run repeats; its stream is not the JAX package's, and the two agree in
distribution (thresholds within the bisection's tolerance). The populations
are float64: in float32 the saturated tails (|LLR| near the 2 atanh clip)
bias the estimate by about 0.1 dB at the (3,6) threshold. The erasure
channel's DE (:func:`bec_erasure_fixed_point`, :func:`bec_threshold`) is
exact numpy, copied unchanged.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ldpc_tpu_torch.utils.device import resolve_device


def regular_protograph(dv: int, dc: int) -> list[tuple[int, int]]:
    """Base edges of the (dv, dc)-regular ensemble.

    lcm(dv, dc)/dc check types x lcm/dv variable types, wired round-robin so
    every variable has degree dv and every check degree dc.
    """
    l = math.lcm(dv, dc)
    n_chk, n_var = l // dc, l // dv
    edges = []
    k = 0
    for _ in range(l):
        edges.append((k % n_chk, k % n_var))
        k += 1
    # round-robin wiring can duplicate (c,v) pairs; that's fine -- each base
    # edge is its own message population (multi-edge protograph)
    return edges


def _edges_of(graph) -> list[tuple[int, int]]:
    """Accept a QCLayout, an edge list, or an AlistMatrix-like base."""
    if hasattr(graph, "edges"):  # QCLayout: (bi, bj, shift)
        return [(bi, bj) for bi, bj, _ in graph.edges]
    return [(int(c), int(v)) for c, v in graph]


def _exclusive(group: np.ndarray) -> np.ndarray:
    """Leave-one-out neighbour lists per edge, padded with the sentinel
    row ``n_edges``."""
    n_e = len(group)
    rows = [[e2 for e2 in range(n_e) if group[e2] == group[e] and e2 != e]
            for e in range(n_e)]
    width = max((len(r) for r in rows), default=0)
    return np.array([r + [n_e] * (width - len(r)) for r in rows],
                    dtype=np.int64).reshape(n_e, width)


class TorchDraws:
    """The sampled DE's random draws from one ``torch.Generator``: the
    channel normals, then each resample's indices, in the order the run
    asks for them."""

    def __init__(self, seed: int, device):
        self.device = device
        self.g = torch.Generator(device=device)
        self.g.manual_seed(int(seed))

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.g, dtype=torch.float64,
                           device=self.device)

    def randint(self, high: int, shape) -> torch.Tensor:
        return torch.randint(0, high, shape, generator=self.g,
                             device=self.device)


def _de_run(edges, sigma2: float, iterations: int, n_samples: int,
            draws) -> float:
    """One sampled DE run over the base ``edges`` (a tuple of (c, v))."""
    device = draws.device
    chk = np.array([c for c, _ in edges])
    var = np.array([v for _, v in edges])
    n_var = int(var.max()) + 1
    excl_chk = torch.as_tensor(_exclusive(chk), device=device)
    excl_var = torch.as_tensor(_exclusive(var), device=device)
    var_t = torch.as_tensor(var, dtype=torch.int64, device=device)
    f64 = torch.float64
    ones = torch.ones((1, n_samples), dtype=f64, device=device)
    zeros = torch.zeros((1, n_samples), dtype=f64, device=device)

    # the channel's mean and deviation in f32, as the JAX function forms
    # them from its f32 sigma^2
    s2 = np.float32(sigma2)
    mean = float(np.float32(2.0) / s2)
    std = float(np.sqrt(np.float32(4.0) / s2))
    m0 = mean + std * draws.normal((n_var, n_samples))

    def resample(x):
        # independent bootstrap resample per population (cycle-free
        # assumption); with replacement, an O(N) gather
        return torch.gather(x, 1, draws.randint(n_samples, tuple(x.shape)))

    def check(M):
        t = torch.tanh(torch.clamp(M / 2.0, -18.0, 18.0))
        # sentinel row in the tanh domain: the multiplicative identity 1
        t = torch.cat([t, ones])
        prod = torch.clamp(t[excl_chk].prod(dim=1), -0.999999, 0.999999)
        return 2.0 * torch.atanh(prod)

    M = m0[var_t]
    for _ in range(iterations):
        E = check(resample(M))
        Ep = torch.cat([resample(E), zeros])
        M = m0[var_t] + Ep[excl_var].sum(dim=1)
    # posterior per variable type: m0 + all incoming E (E recomputed once)
    post = m0.index_add(0, var_t, check(M))
    return float((post < 0.0).to(f64).mean())


def de_error_probability(
    graph,
    ebno_db: float,
    rate: float,
    iterations: int = 200,
    n_samples: int = 20000,
    seed: int = 0,
    device=None,
    draws=TorchDraws,
) -> float:
    """Residual error probability of BP on the ensemble at the given Eb/N0
    (``device=None``: the card). ``draws(seed, device)`` makes the run's
    random source (:class:`TorchDraws`); a test can hand both packages the
    same draws through it."""
    edges = tuple(_edges_of(graph))
    sigma2 = 1.0 / (2.0 * rate * 10.0 ** (ebno_db / 10.0))
    return _de_run(edges, sigma2, iterations, n_samples,
                   draws(seed, resolve_device(device)))


def bec_erasure_fixed_point(graph, epsilon: float, iterations: int = 2000,
                            tol: float = 1e-9) -> float:
    """Exact protograph density evolution on the binary erasure channel.

    Per-edge erasure probabilities evolve deterministically:
        check:    y_e = 1 - prod_{e' at c, e' != e} (1 - x_{e'})
        variable: x_e = eps * prod_{e' at v, e' != e} y_{e'}
    Returns the residual average variable erasure probability (0 when BP
    succeeds). No sampling -- exact to float precision.
    """
    edges = _edges_of(graph)
    n_e = len(edges)
    chk = np.array([c for c, _ in edges])
    var = np.array([v for _, v in edges])
    n_var = int(var.max()) + 1

    def excl(group):
        rows = [[e2 for e2 in range(n_e) if group[e2] == group[e] and e2 != e]
                for e in range(n_e)]
        width = max((len(r) for r in rows), default=0)
        return np.array(
            [r + [n_e] * (width - len(r)) for r in rows], dtype=np.int64
        ).reshape(n_e, width)

    ec, ev = excl(chk), excl(var)
    x = np.full(n_e + 1, epsilon)
    x[n_e] = 0.0  # sentinel: a non-edge never erases (check identity)
    for _ in range(iterations):
        y = 1.0 - np.prod(1.0 - x[ec], axis=1)
        yp = np.concatenate([y, [1.0]])  # sentinel: variable identity
        x_new = np.concatenate([epsilon * np.prod(yp[ev], axis=1), [0.0]])
        if np.abs(x_new - x).max() < tol:
            x = x_new
            break
        x = x_new
    # a-posteriori erasure per variable: eps * prod of ALL incoming y
    y = 1.0 - np.prod(1.0 - x[ec], axis=1)
    post = np.full(n_var, epsilon)
    for e in range(n_e):
        post[var[e]] *= y[e]
    return float(post.mean())


def bec_threshold(graph, lo: float = 0.01, hi: float = 0.99,
                  tol: float = 1e-4, target: float = 1e-9) -> float:
    """BP threshold epsilon* on the BEC by bisection (exact DE).

    Anchor: the (3,6)-regular ensemble has epsilon* = 0.4294.
    """
    if bec_erasure_fixed_point(graph, hi) < target:
        raise ValueError(f"threshold above hi={hi}")
    if bec_erasure_fixed_point(graph, lo) >= target:
        raise ValueError(f"threshold below lo={lo}")
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if bec_erasure_fixed_point(graph, mid) < target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def protograph_threshold(
    graph,
    rate: float,
    lo_db: float = 0.0,
    hi_db: float = 4.0,
    tol_db: float = 0.05,
    iterations: int = 200,
    n_samples: int = 20000,
    target: float = 1e-3,
    seed: int = 0,
    device=None,
    draws=TorchDraws,
) -> float:
    """BP threshold in Eb/N0 (dB) by bisection on de_error_probability.

    Raises if the threshold lies outside [lo_db, hi_db] (the bracket
    endpoints are evaluated first), rather than silently returning an
    endpoint as the answer.
    """
    kw = dict(rate=rate, iterations=iterations, n_samples=n_samples, seed=seed,
              device=device, draws=draws)
    if de_error_probability(graph, hi_db, **kw) >= target:
        raise ValueError(
            f"BP threshold above hi_db={hi_db} dB (pe >= {target} there); "
            f"raise hi_db"
        )
    if de_error_probability(graph, lo_db, **kw) < target:
        raise ValueError(
            f"BP threshold below lo_db={lo_db} dB (pe < {target} there); "
            f"lower lo_db"
        )
    lo, hi = lo_db, hi_db
    while hi - lo > tol_db:
        mid = 0.5 * (lo + hi)
        pe = de_error_probability(graph, mid, **kw)
        if pe < target:
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)
