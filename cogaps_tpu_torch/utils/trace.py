"""Host-side spans of the program's steps, on torch.profiler's clock.

``span(name, **counts)`` marks a step (the layer boundaries of the fused
route: ``run_phase``, ``run_span`` and its parts, and the kernel
libraries' loads). The tracer is off until ``start()`` or
``recording()`` turns it on:

    from cogaps_tpu_torch.utils import trace
    with trace.recording() as spans:
        CoGAPS(...)
    for s in spans:
        s.name, s.start_ns, s.end_ns, s.parent, s.counts

Each record is a ``Span``: start and end in Unix nanoseconds, the clock
of torch.profiler's kineto events, so a span sets beside a profiled
device event's ``start_ns`` directly; ``parent``, the index in the same
list of the innermost span open at its start (None at the top); and
``counts``, a small dict of ints. Whatever is on, a span reads no tensor
and synchronises no device: it times the host's work, which on a card
only enqueues.

While torch.profiler records, each span is also a host event of the
profile, recorded as PyTorch records its own operations (a
function-scope record), so a profile's host events name the program's
steps beside PyTorch's operations and its device events stay the
device's own (``record_function``'s user scope would add a device event
over the kernels of each span). With the tracer off and no profiler,
``span`` returns one shared no-op object: it reads no clock and records
nothing. Spans nest by the order of entry, so they record one thread's
steps.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    counts: dict


# while on, one [name, start, end, parent, counts] a span
_records: Optional[list] = None
_open: list = []  # indices into _records of the spans open now


class _Off:
    """The span while the tracer is off and nothing profiles."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts) -> None:
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "counts", "records", "index", "annotation")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts
        self.records = self.index = self.annotation = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.annotation = _RecordFunctionFast(self.name)
            self.annotation.__enter__()
        if _records is not None:
            self.records, self.index = _records, len(_records)
            _records.append([self.name, time.time_ns(), None,
                             _open[-1] if _open else None, self.counts])
            _open.append(self.index)
        return self

    def __exit__(self, *exc):
        if self.records is not None and self.records is _records:
            self.records[self.index][2] = time.time_ns()
            _open.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False

    def add(self, **counts) -> None:
        """Counts known only inside the span."""
        self.counts.update(counts)


def span(name: str, **counts):
    """A context manager that marks one step; its `add(**counts)` adds
    counts found inside it."""
    if _records is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, counts)


def on() -> bool:
    return _records is not None


def start() -> None:
    """Turn the tracer on, with no records."""
    global _records
    if _records is not None:
        raise RuntimeError("the tracer is already on")
    _records = []
    _open.clear()


def stop() -> list:
    """Turn the tracer off and return its records in order of entry. A
    span still open ends now."""
    global _records
    if _records is None:
        raise RuntimeError("the tracer is off")
    records, _records = _records, None
    now = time.time_ns()
    _open.clear()
    return [Span(n, s, now if e is None else e, p, c)
            for n, s, e, p, c in records]


@contextlib.contextmanager
def recording():
    """The tracer on over a `with` block, which binds a list that holds
    the records when the block ends, by an exception too."""
    out: list = []
    start()
    try:
        yield out
    finally:
        out.extend(stop())
