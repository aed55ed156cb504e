"""prrn_aln_tpu_torch — the PyTorch and CUDA port of ``prrn_aln_tpu``.

The JAX package ``prrn_aln_tpu`` beside it is the reference this port is
held against.  Device code here is PyTorch plus hand-written CUDA
kernels for Hopper (``csrc/``); every device entry point takes an
explicit ``device``.  On a CPU device the kernels' plain PyTorch
versions run instead; on a CUDA device the kernels run, with no
fallback.  The host NumPy modules are copies of the JAX package's,
because importing anything from ``prrn_aln_tpu`` imports JAX.
"""

__version__ = "0.1.0"

import torch as _torch

# The DP scores are compared bit for bit with the JAX reference, so no
# float32 product may run in TF32 (about three decimal digits).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
