"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At the first CUDA call, one ``nvcc`` per source compiles them all at
once into objects, then one more links the objects into a shared library
with a plain C interface, in ``build/prrn_aln_tpu_torch/`` under the
repository root (git-ignored).  The library's name carries a hash of
the sources, the headers they include (``csrc/*.cuh``) and the flags,
so an edited source or header is rebuilt and a stale library is never
loaded.  Importing this module runs nothing: the CPU tests import every
module and have no ``nvcc``.

``-fmad=false`` keeps each kernel's float arithmetic operation for
operation equal to its plain PyTorch version (no fused multiply-add),
so the kernels are compared bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..utils import trace

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = (Path(__file__).resolve().parent.parent.parent / "build"
          / "prrn_aln_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

_vp, _int, _flt = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the kernels' launchers; each returns cudaGetLastError()
_SIGNATURES = {
    "pairwise_scores_launch": [_vp] * 13 + [_int] * 14 + [_vp],
    "pairwise_rows_launch": [_vp] * 13 + [_int] * 12 + [_vp],
    "pairwise_rows_attrs": [_int, _int, _vp],
    "group_wavefront_launch": [_vp] * 22 + [_int] * 15 + [_vp],
    "group_wavefront_attrs": [_int, _int, _int, _vp],
    "pairwise_scores_attrs": [_int, _int, _int, _vp],
    "traceback_launch": [_vp] * 12 + [_int] * 10 + [_vp],
    "traceback_attrs": [_int, _vp],
    "spliced_h_wave_launch": [_vp] * 20 + [_int] * 16 + [_vp],
    "spliced_h_wave_attrs": [_int, _vp],
    "spliced_h_wave_scratch_words": [],
    "spliced_h_wave_chain_words": [_int] * 2,
    "spliced_h_wave_max_clusters": [_int] * 4 + [_vp],
    "spliced_h_walk_launch": [_vp] * 3 + [_int] * 10 + [_vp],
    "spliced_h_walk_attrs": [_vp],
    "spliced_s_wave_launch": [_vp] * 21 + [_int] * 16 + [_vp],
    "spliced_s_wave_scratch_words": [_int, _int],
    "spliced_s_wave_chain_words": [_int] * 3,
    "spliced_s_wave_attrs": [_int, _vp],
    "spliced_s_wave_max_clusters": [_int] * 4 + [_vp],
    "frontier_sweep_launch": [_vp] * 7 + [_int] * 8 + [_flt] * 2 + [_vp],
    "frontier_row_launch": [_vp] * 8 + [_int] * 8 + [_flt] * 6 + [_vp],
}

_lib = None
# launches of each kernel, counted by its wrapper where it launches: the
# tracer's counters, under the kernel's name
LAUNCHES = trace.COUNTS


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    """The headers the sources include (``csrc/*.cuh``)."""
    return sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD / f"libprrn_kernels_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Build the kernels if their library is missing, then load it.
    Raises on any build failure: there is no fallback."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        objs = [_BUILD / f"{tag}.{src.stem}.o" for src in _sources()]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_sources(), objs)]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed:\n" + " ".join(cmd) + "\n"
                                   + log)
        cmd = [_nvcc(), "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
               *(str(obj) for obj in objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + " ".join(cmd)
                               + "\n" + res.stdout + res.stderr)
        for obj in objs:
            obj.unlink()
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def require(t, name: str, dtype, shape, device) -> None:
    """Raise unless the tensor is what a kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
