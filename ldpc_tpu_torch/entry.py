"""Single-device entry point: the flagship code's flooding SPA decode step.

Counterpart of ``__graft_entry__.py`` ``entry()`` (``:19-37``):
:func:`entry` returns ``(fn, (llr,))``, where ``fn(llr)`` decodes 256 frames
of N(0, 1) LLRs (``numpy.random.default_rng(0)``) of WiMAX (1152, 576) rate
1/2 with the flooding SPA decoder (exact rule, ``orig`` graph, 10
iterations) and returns ``(est, ok, conv_iter)``. The decoder is the plain
PyTorch one (``ops.spa.make_decoder``): the JAX package's is plain XLA, no
Pallas kernel.

Run as a script, it decodes the example once, prints the three shapes, then
runs the multi-process dry run of the sharded sweep step
(``parallel.dryrun``, the counterpart of ``dryrun_multichip``) over the
cards this host has, one rank each (one rank where ``main`` is given
``device="cpu"``)::

    python -m ldpc_tpu_torch.entry               # on the card
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ldpc_tpu_torch.utils.device import resolve_device

FRAMES = 256
ITERATIONS = 10


def _flagship_code():
    """WiMAX (1152, 576) rate-1/2, constructed from the built-in IEEE
    802.16e base matrix."""
    from ldpc_tpu_torch.sim.runner import load_code

    return load_code("wimax_1152_0.5.alist.txt")


def entry(device=None):
    """(fn, example_args): the SPA decode step on the flagship code, on
    ``device`` (``None``: the card)."""
    from ldpc_tpu_torch.ops.spa import make_decoder

    dev = resolve_device(device)
    code = _flagship_code()
    spec = code.standard_encode_spec
    decode = make_decoder(
        code.layout("orig"), spec.info_pos("orig"), max_iterations=ITERATIONS,
        variant="spa", rule="exact", device=dev,
    )

    def fn(llr):
        res = decode(llr)
        return res.est, res.ok, res.conv_iter

    llr = torch.as_tensor(
        np.random.default_rng(0).normal(size=(FRAMES, code.n)),
        dtype=torch.float32, device=dev)
    return fn, (llr,)


def main(argv=None, device=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]) \
        .parse_args(argv)
    from ldpc_tpu_torch.parallel.dryrun import dryrun_multiprocess

    dev = resolve_device(device)
    fn, example = entry(dev)
    out = fn(*example)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print("entry() run OK:", [tuple(o.shape) for o in out], flush=True)
    if dev.type == "cuda":
        dryrun_multiprocess(torch.cuda.device_count())
    else:
        dryrun_multiprocess(1, "cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
