"""Spans and counters of the port: where a call, a sweep and set-up spend
their host time.

A span is one stretch of host time at a layer boundary: its name, an id, the
id of the span open around it (None for a root), its unit (the root's id:
every span of one ``run_point`` call or one ``run_simulation`` sweep shares
it), its start and end on ``time.perf_counter_ns`` and a few attributes.
Counters (batches, frames, host fetches, probes, overhead measures, split
batches, lane trips, X-row bytes) are kept per unit, on the root span's attributes;
:func:`annotate` sets attributes of the innermost open span. Finished spans
go to a ring of :data:`RING` spans, so a long run cannot grow without limit.

Two tiers:

* :func:`span` and :func:`traced` are always recorded. They sit where the
  cost is bounded by calls, not batches: a call, a flush, a probe, a point,
  an executor build, a code or kernel-library load.
* :func:`batch_span` (one batch's draw, encode, channel, decode and
  counters) is recorded only while a ``torch.profiler`` session is active,
  or inside :func:`batch_spans`; otherwise it costs a flag test and returns
  a shared null context.

While a profiler session is active, every span also enters a
``RecordFunction`` of its name: it becomes a host event of the profiler's own
trace, on its clock, and labels the card's idle gaps there. It enters at the
scope of an operator (``torch._C._profiler._RecordFunctionFast``), not as
``torch.profiler.record_function``'s user annotation: the profiler gives each
user annotation a range on the card too (``gpu_user_annotation``), from the
first to the last kernel launched inside it, and a reader that takes every
device event for work would find the card busy across each call. The
profiler cannot be asked whether its session records host activity, so the
per-batch tier runs under a session that records the card alone too.

:func:`units` groups the ring by unit, :func:`self_ns` gives a span's self
time, and :meth:`Recorder.export` writes the ring as JSON (``run_simulation``
does, to ``DIR/spans.json``, under ``--profile DIR``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import threading
import time

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

RING = 1 << 17
BATCH = "batch."  # the prefix of the per-batch tier's names


class Span:
    """One span; a context manager that records it when it closes."""

    __slots__ = ("name", "id", "parent", "unit", "t0", "t1", "attrs", "_rec",
                 "_rf")

    def __init__(self, rec: Recorder, name: str, attrs: dict):
        self._rec, self.name, self.attrs = rec, name, attrs
        self.parent = self.t1 = None

    def __enter__(self) -> Span:
        stack = self._rec._stack()
        self.id = next(self._rec._ids)
        if stack:
            self.parent, self.unit = stack[-1].id, stack[-1].unit
        else:
            self.unit = self.id
        stack.append(self)
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self._rec._stack().pop()
        self._rec.spans.append(self)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "unit": self.unit, "start_ns": self.t0, "end_ns": self.t1,
                "attrs": self.attrs}


class Recorder:
    """The ring of finished spans (oldest first in the order they closed)
    and, per thread, the stack of open ones."""

    def __init__(self, capacity: int = RING):
        self.spans: collections.deque[Span] = collections.deque(
            maxlen=capacity)
        self.batch_tier = False  # per-batch spans without a profiler
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    def count(self, name: str, n: int = 1) -> None:
        """Adds ``n`` to counter ``name`` of the open unit (nothing when no
        span is open)."""
        stack = self._stack()
        if stack:
            a = stack[0].attrs
            a[name] = a.get(name, 0) + n

    def annotate(self, **attrs) -> None:
        """Sets attributes of the innermost open span (nothing when no span
        is open)."""
        stack = self._stack()
        if stack:
            stack[-1].attrs.update(attrs)

    def full(self) -> bool:
        """Whether the ring may have dropped its oldest spans."""
        return len(self.spans) == self.spans.maxlen

    def export(self, path, **extra) -> None:
        """Writes the ring, and ``extra``, as one JSON object to ``path``."""
        with open(path, "w") as f:
            json.dump({"clock": "perf_counter_ns", "ring": self.spans.maxlen,
                       "spans": [s.as_dict() for s in self.spans], **extra},
                      f)


RECORDER = Recorder()
_NULL = contextlib.nullcontext()


def span(name: str, **attrs) -> Span:
    """A span of the always-recorded tier: ``with span("flush"): ...``."""
    return RECORDER.span(name, **attrs)


def traced(name: str):
    """Decorator: each call of the function is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with RECORDER.span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def batch_span(name: str):
    """A span of the per-batch tier, or the shared null context when that
    tier is off."""
    if RECORDER.batch_tier or _profiler._is_profiler_enabled:
        return RECORDER.span(name)
    return _NULL


def count(name: str, n: int = 1) -> None:
    RECORDER.count(name, n)


def annotate(**attrs) -> None:
    RECORDER.annotate(**attrs)


@contextlib.contextmanager
def batch_spans():
    """Records the per-batch tier without a profiler session (the tests,
    and the measure of what the tier costs)."""
    rec = RECORDER
    before, rec.batch_tier = rec.batch_tier, True
    try:
        yield rec
    finally:
        rec.batch_tier = before


def is_batch(s: Span) -> bool:
    return s.name.startswith(BATCH)


def units(spans, root: str) -> list[tuple[Span, list[Span]]]:
    """``(root span, every span of its unit)`` for each root span named
    ``root``, in the order they started."""
    members: dict[int, list[Span]] = {}
    for s in spans:
        members.setdefault(s.unit, []).append(s)
    roots = sorted((s for s in spans if s.parent is None and s.name == root),
                   key=lambda s: s.t0)
    return [(r, members[r.id]) for r in roots]


def self_ns(s: Span, spans) -> int:
    """``s``'s duration less the part of it that its children (the spans of
    ``spans`` whose parent it is) cover."""
    covered, end = 0, s.t0
    for c0, c1 in sorted((c.t0, c.t1) for c in spans if c.parent == s.id):
        c0, c1 = max(c0, end), min(c1, s.t1)
        if c1 > c0:
            covered += c1 - c0
            end = c1
    return s.t1 - s.t0 - covered
