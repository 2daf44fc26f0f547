"""Matrix-database discovery (the port's copy of the JAX package's module).

The framework consumes ALIST files from any directory. For convenience the
standard locations are probed in order: $LDPC_TPU_MATRIX_DB and a
Channel_Codes_Database directory in the current working directory; nothing
outside it is searched. Names with a ``builtin:`` prefix resolve to the
constructed standard codes (ldpc_tpu_torch.models.standards) with no
database at all.
"""

from __future__ import annotations

import os

_CANDIDATES = [
    os.environ.get("LDPC_TPU_MATRIX_DB", ""),
    "Channel_Codes_Database",
]


def default_matrix_db() -> str | None:
    for cand in _CANDIDATES:
        if cand and os.path.isdir(cand):
            return cand
    return None


def find_matrix(name: str, db: str | None = None) -> str | None:
    """Locate a matrix file by basename anywhere under the database."""
    if os.path.isfile(name):
        return name
    db = db or default_matrix_db()
    if db is None:
        return None
    for root, _dirs, files in os.walk(db):
        if name in files:
            return os.path.join(root, name)
    return None


def resolve_matrix(name: str) -> str:
    """Resolve a --matrix argument to a loadable source.

    Resolution order: explicit ``builtin:`` URI -> existing file path ->
    basename found under the matrix database -> built-in standard code with
    that canonical name (ldpc_tpu_torch.models.standards) -> error. The returned
    string is either a filesystem path or ``builtin:<name>``.
    """
    from ldpc_tpu_torch.models import standards

    if name.startswith("builtin:"):
        if not standards.is_builtin(name):
            raise FileNotFoundError(f"Unknown built-in code: {name}")
        return name
    found = find_matrix(name)
    if found is not None:
        return found
    if standards.is_builtin(name):
        return f"builtin:{os.path.basename(name)}"
    raise FileNotFoundError(
        f"Matrix {name!r}: not a file, not under the matrix database, and not "
        f"a built-in standard code"
    )
