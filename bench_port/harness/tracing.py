"""Spans, kernel events and counters of a traced run (``--trace 1``).

Installed from the benchmark around the program's layer entry points
and kernel launchers, and taken out again once the window has closed;
a run with ``--trace 0`` installs nothing.

* Layer spans: host clock around ``msa.distance.distance_matrix``,
  ``pipeline.progressive_msa`` and ``pipeline.refine_with_consreg`` /
  ``refine_msa``, each started and ended by ``torch.cuda.synchronize()``,
  and named to the profiler by ``record_function``.
* Kernel events: CUDA events recorded on the current stream just before
  and after each call of a launcher of the library ``_build.load()``
  returns, one for each file of ``kernels/`` (its ``LAUNCHER``).  Where
  the file names a program function to ``KEEP``, that call's inputs are
  kept (the small per-pair tensors only) so that the kernel's ``work``
  can be counted from them once the window has closed.
* The program's launch counter ``_build.LAUNCHES``, read by family.
"""

from __future__ import annotations

import importlib
import time
from dataclasses import dataclass, field

from harness import load, names


def merged(intervals) -> list[list[float]]:
    """The union of (start, end) intervals as disjoint ones, in order."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclass
class KernelCall:
    kernel: str
    start: object                 # torch.cuda.Event
    end: object
    inputs: dict | None = None


@dataclass
class Trace:
    spans: list = field(default_factory=list)     # (layer, seconds)
    calls: list = field(default_factory=list)     # KernelCall
    _undo: list = field(default_factory=list)
    _pending: dict = field(default_factory=dict)

    def install(self, torch) -> None:
        from prrn_aln_tpu_torch import pipeline
        from prrn_aln_tpu_torch.msa import distance
        from prrn_aln_tpu_torch.ops import _build

        def patch(owner, name, wrap):
            orig = getattr(owner, name)
            setattr(owner, name, wrap(orig))
            self._undo.append((owner, name, orig))

        def span(layer):
            def wrap(orig):
                def inner(*a, **kw):
                    with torch.profiler.record_function(layer):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        try:
                            return orig(*a, **kw)
                        finally:
                            torch.cuda.synchronize()
                            self.spans.append(
                                (layer, time.perf_counter() - t0))
                return inner
            return wrap

        patch(distance, "distance_matrix", span("distance"))
        patch(pipeline, "progressive_msa", span("progressive"))
        patch(pipeline, "refine_with_consreg", span("refine"))
        patch(pipeline, "refine_msa", span("refine"))

        def keep(kernel, pick):
            def wrap(orig):
                def inner(*a, **kw):
                    self._pending[kernel] = pick(*a, **kw)
                    try:
                        return orig(*a, **kw)
                    finally:
                        self._pending.pop(kernel, None)
                return inner
            return wrap

        def timed(kernel):
            def wrap(orig):
                def inner(*a):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    err = orig(*a)
                    end.record()
                    self.calls.append(KernelCall(
                        kernel, start, end, self._pending.pop(kernel, None)))
                    return err
                return inner
            return wrap

        lib = _build.load()
        for kernel in names("kernels"):
            k = load("kernels", kernel)
            if hasattr(k, "KEEP"):
                owner = importlib.import_module(k.KEEP[0])
                patch(owner, k.KEEP[1], keep(kernel, k.inputs))
            patch(lib, k.LAUNCHER, timed(kernel))

    def uninstall(self) -> None:
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)
