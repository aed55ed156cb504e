"""The port's one tracer: counters, always on, and spans, on request.

``COUNTS`` (a ``collections.Counter``) is counted into where the work
happens: every kernel launch (``ops._build.LAUNCHES`` is this object),
the refinement's candidates, K2's steps, K3's moves and the bytes the
wrappers copy between the host and the device (on a CPU device, the
bytes such a copy would move).  A count is an integer add and is never
switched off.  A launch is counted under its kernel's name, every other
count under a dotted name (``refine.accepted``); ``launches()`` gives
the launches alone.

``with span(name):`` times one part of a request.  Off (the default) it
costs one flag check and returns one shared no-op context.  After
``enable()`` each span keeps a record in memory (``Span``: its name, its
start and end on ``time.perf_counter_ns``, the index of the span it
opened inside, -1 for none, and its request) and enters
``torch.profiler.record_function(name)``, so that a profiler that is
recording puts the span on its own timeline, on the clock of the
device's operations.  ``request(name)`` opens a span under a new
request id: the root of one call of the command line.  ``take()``
returns the records made since the last ``take()`` and forgets them;
``disable()`` stops recording.

Neither a span nor a count waits for the device: a count that needs a
device value is made where the program already holds it on the host.
Counts and records are the process's; the tracer assumes one thread.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import NamedTuple

import torch

COUNTS: collections.Counter = collections.Counter()


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int          # index in the same ``take()``, -1 for a root
    request: int         # 0 outside any request


_OFF = contextlib.nullcontext()
_on = False
_records: list = []      # [name, start, end, parent record, request]
_open: list = []         # the records of the spans entered and not left
_requests = 0


class _Recording:
    __slots__ = ("_rec", "_fn", "_request")

    def __init__(self, name: str, request: int | None = None):
        self._rec = [name, 0, 0, None, 0]
        self._fn = torch.profiler.record_function(name)
        self._request = request

    def __enter__(self):
        rec = self._rec
        if _open:
            rec[3] = _open[-1]
            rec[4] = _open[-1][4]
        if self._request is not None:
            rec[4] = self._request
        _records.append(rec)
        _open.append(rec)
        self._fn.__enter__()
        rec[1] = time.perf_counter_ns()

    def __exit__(self, *exc):
        self._rec[2] = time.perf_counter_ns()
        self._fn.__exit__(*exc)
        _open.pop()
        return False


def span(name: str):
    """A context that records ``name`` while tracing is on."""
    if not _on:
        return _OFF
    return _Recording(name)


def request(name: str):
    """``span(name)`` as the root of a new request."""
    global _requests
    if not _on:
        return _OFF
    _requests += 1
    return _Recording(name, _requests)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> list[Span]:
    """The records made since the last call, in the order their spans
    were entered; a span still open has ``end_ns`` 0."""
    global _records
    recs, _records = _records, []
    index = {id(r): k for k, r in enumerate(recs)}
    return [Span(r[0], r[1], r[2], index.get(id(r[3]), -1), r[4])
            for r in recs]


def launches() -> dict:
    """The kernel launches among ``COUNTS``: the keys with no dot."""
    return {k: n for k, n in COUNTS.items() if "." not in k}


def h2d(t: torch.Tensor) -> torch.Tensor:
    """``t``, just copied from host memory to its device, counted
    (``copy.h2d_bytes``)."""
    COUNTS["copy.h2d_bytes"] += t.numel() * t.element_size()
    return t


def d2h(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, counted (``copy.d2h_bytes``)."""
    COUNTS["copy.d2h_bytes"] += t.numel() * t.element_size()
    return t.cpu()
