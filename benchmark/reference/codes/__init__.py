"""Code families, found by name: ``benchmark/reference/codes/<family>.py``
holds one function, ``build(code: dict) -> QCCode``, that builds the code a
configuration's ``code`` object names from its standard's tables. A new
family is a new file here; no existing file changes.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

from benchmark.reference.code import QCCode

HERE = Path(__file__).resolve().parent


def families(here: Path = HERE) -> list[str]:
    return sorted(p.stem for p in here.glob("*.py") if p.stem != "__init__")


def build(code: dict, here: Path = HERE) -> QCCode:
    """The code of ``code["family"]``, held to the ``n``, ``k`` and ``z``
    that ``code`` states."""
    family, have = code.get("family"), families(here)
    if family not in have:
        raise SystemExit(f"code family {family!r} is not one of "
                         f"{', '.join(have)} (benchmark/reference/codes/)")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.reference.codes.{family}", here / f"{family}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    qc = mod.build(code)
    built = (qc.n, qc.k, qc.Z)
    stated = (code.get("n"), code.get("k"), code.get("z"))
    if built != stated:
        raise SystemExit(f"code family {family!r} built (n, k, z) = {built}; "
                         f"the configuration states {stated}")
    return qc
