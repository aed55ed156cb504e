"""The reference's float types and its K2 engine.

By default those the configuration states: the DP lanes in float32,
K2's profile products and crg sums in float64 (each an exact product of
float32 factors), K2 run by its NumPy restatement (``wavefront_np``).
``lowered()`` puts each type one step down, float32 for float64 and
bfloat16 for float32, on the frozen PyTorch K2 (NumPy has no bfloat16):
the control that the benchmark's comparison has to fail.  ``torch_k2()``
runs that same PyTorch K2 at the stated types: the witness that the two
engines agree at the sizes the control runs at, so that what the control
changes is the precision alone.  Read at each call, so a switch holds
for the code run inside its ``with`` block.
"""

from __future__ import annotations

import contextlib

import torch

F32 = torch.float32
F64 = torch.float64
NUMPY_K2 = True


@contextlib.contextmanager
def _set(**kw):
    saved = {k: globals()[k] for k in kw}
    globals().update(kw)
    try:
        yield
    finally:
        globals().update(saved)


def lowered():
    return _set(F32=torch.bfloat16, F64=torch.float32, NUMPY_K2=False)


def torch_k2():
    return _set(NUMPY_K2=False)
