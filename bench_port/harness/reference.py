"""The plain reference's alignments, one worker process a family.

A configuration names its reference, ``"<module>:<function>"`` under
``bench_port/`` (for ``prrn``: ``prrn_ref.pipeline:align_family``),
called as ``function(names, seqs)``.  Each worker is a fresh process
(``spawn``) on the host alone, with one thread: it imports PyTorch and
the reference and never touches the card.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import importlib
import multiprocessing

# the reference's switches (``prrn_ref.precision``): None, the stated
# precision; "lowered", the control; "torch_k2", the control's engine
# at the stated precision
MODES = (None, "lowered", "torch_k2")


def reference_rows(job: tuple) -> list[tuple[str, str]]:
    """(name, aligned row) of one family by the plain reference; job is
    (reference, names, seqs, mode), ``mode`` one of ``MODES``."""
    call, names, seqs, mode = job
    import torch
    torch.set_num_threads(1)
    from prrn_ref import precision
    module, function = call.split(":")
    fn = getattr(importlib.import_module(module), function)
    with getattr(precision, mode)() if mode else contextlib.nullcontext():
        return fn(names, seqs)


def references(jobs: list[tuple], workers: int | None = None
               ) -> list[list[tuple[str, str]]]:
    """``reference_rows`` of each job, on ``workers`` processes (one a
    job by default), all waited for."""
    if not jobs:
        return []
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            min(len(jobs), workers or len(jobs)), mp_context=ctx) as ex:
        return list(ex.map(reference_rows, jobs))
