"""The multi-device paths on ``torch.distributed``, and the band-frontier
ring of one long banded pair (kernel K6).

Counterpart of ``prrn_aln_tpu/ops/frontier.py`` and of the JAX package's
``mesh=`` keyword.  The JAX package is one controller over a device
``Mesh``; the port is one process a rank: every rank calls the same
function with the same arguments and a ``torch.distributed`` process
group, computes its own shard on its own ``device``, and returns the
whole result.  What crosses between ranks is small (score vectors, SKL
paths, a few boundary scalars a row), so the collectives run on gloo
over host tensors; gloo also lets several ranks share one card, which
NCCL refuses.

* ``shard_block`` and ``gather_blocks``: a batch of B items splits into
  contiguous blocks of ceil(B / world) items, one a rank (the JAX split
  ``P(axis)`` after padding to a multiple of the device count), and the
  blocks come back in rank order by one ``all_gather_object``.
* ``frontier_pairwise_score``: the global banded affine score of one
  pair with the band split over the ranks.  Lane j of row m holds column
  n = m + lw + j (the row sweep of ``pallas_pairwise.py``); each rank
  holds ``Wl`` lanes.  A row makes the JAX function's three exchanges in
  its order: the right neighbour's first lane of H and G, the left
  neighbour's last lane of X, and a (world - 1)-hop chain of the running
  maximum of the horizontal-gap scan.  H and G stay on the device; only
  the boundary scalars cross to the host.  The row step is kernel K6
  (``csrc/frontier_row.cu``), split at the exchanges into three entry
  points (``row_edges``, ``row_scan``, ``row_close``); their plain
  versions follow the JAX arithmetic operation for operation, and
  ``frontier_row_ref`` is the whole step with the received values given.
* ``maybe_init_distributed``: joins a gloo process group when the JAX
  function's environment variables ask for one.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from . import _build
from .spliced_s import _fma32

NEVSEL = -1.0e30
NEG_SENT = -(2 ** 31 // 8) * 7.0

# the lanes of one rank's shard are a multiple of this
LANE_QUANTUM = 8


def shard_block(n: int, group) -> tuple[int, int, int, int]:
    """(rank, world, start, stop): this rank's block of ``n`` items."""
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    per = -(-n // world)
    start = min(n, rank * per)
    return rank, world, start, min(n, start + per)


def gather_blocks(block: list, group) -> list:
    """Every rank's ``block``, concatenated in rank order."""
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, block, group=group)
    return [x for part in parts for x in part]


def maybe_init_distributed() -> bool:
    """Join a gloo process group when the coordinator environment of the
    JAX function is present (``JAX_COORDINATOR_ADDRESS`` or
    ``COORDINATOR_ADDRESS``, or ``PRRN_DIST=1``; ``NUM_PROCESSES``,
    ``PROCESS_ID``).  No-op on single-process runs; a failure prints one
    line to stderr and returns False."""
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS") \
        or os.environ.get("COORDINATOR_ADDRESS")
    if not addr and os.environ.get("PRRN_DIST") != "1":
        return False
    kw = {"init_method": f"tcp://{addr}" if addr else "env://"}
    np_ = os.environ.get("NUM_PROCESSES")
    pid = os.environ.get("PROCESS_ID")
    if np_ is not None:
        kw["world_size"] = int(np_)
    if pid is not None:
        kw["rank"] = int(pid)
    try:
        dist.init_process_group("gloo", **kw)
        return True
    except Exception as e:
        print(f"; torch.distributed init skipped: {e}", file=sys.stderr)
        return False


def band_rows(a: np.ndarray, b: np.ndarray, lw: int, mtx,
              Wp: int) -> np.ndarray:
    """Band-packed substitution rows: s_rows[m, j] = S[m, m + lw + j],
    NEG_SENT off the matrix (as the JAX function packs them)."""
    la, lb = len(a), len(b)
    S = np.asarray(mtx, np.float32)[np.asarray(a)[:, None],
                                    np.asarray(b)[None, :]]
    jj = np.arange(Wp)
    s_rows = np.full((la, Wp), NEG_SENT, np.float32)
    n_idx = np.arange(la)[:, None] + lw + jj[None, :]
    ok = (n_idx >= 0) & (n_idx < lb)
    mg, jg = np.nonzero(ok)
    s_rows[mg, jg] = S[mg, n_idx[mg, jg]]
    return s_rows


def row_init(j0: int, Wl: int, lw: int, up: int, u: float, v: float,
             device) -> tuple[torch.Tensor, torch.Tensor]:
    """H and G of the virtual row m = -1 on lanes j0 .. j0 + Wl - 1."""
    uf, vf = np.float32(u), np.float32(v)
    nv = np.arange(j0, j0 + Wl, dtype=np.int32) + lw - 1
    inside = -(vf + (nv + 1).astype(np.float32) * uf)
    hinit = np.where(nv == -1, np.float32(0.0),
                     np.where((nv >= 0) & (nv + 1 <= up), inside,
                              np.float32(NEG_SENT))).astype(np.float32)
    return (torch.as_tensor(hinit, device=device),
            torch.full((Wl,), NEVSEL, dtype=torch.float32, device=device))


def _lanes(X: torch.Tensor, j0: int) -> torch.Tensor:
    return torch.arange(j0, j0 + X.shape[0], device=X.device)


def _n_vec(m: int, lw: int, jglob: torch.Tensor) -> torch.Tensor:
    # (mf + lw) + jglob, in f32: the JAX function's order
    return (torch.tensor(float(m), dtype=torch.float32) + float(lw)) \
        + jglob.to(torch.float32)


def _ju(jglob: torch.Tensor, u: float) -> torch.Tensor:
    return jglob.to(torch.float32) * torch.tensor(u, dtype=torch.float32)


def row_edges_ref(H, G, s_row, hedge: float, gedge: float, u: float,
                  v: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Entry point (a): G0 and X from H, G, the right neighbour's first
    lane of H and G (``hedge``, ``gedge``) and the row's scores."""
    f32 = torch.float32
    uf, vf = torch.tensor(u, dtype=f32), torch.tensor(v, dtype=f32)
    Hs = torch.cat([H[1:], torch.full((1,), hedge, dtype=f32,
                                      device=H.device)])
    Gs = torch.cat([G[1:], torch.full((1,), gedge, dtype=f32,
                                      device=H.device)])
    G0 = torch.maximum(Hs - vf, Gs) - uf
    D0 = H + s_row
    return G0, torch.maximum(D0, G0)


def row_scan_ref(X, xin: float, m: int, j0: int, lw: int, u: float,
                 v: float) -> torch.Tensor:
    """Entry point (b): C from X and the left neighbour's last lane of X
    (``xin``), then T = C + j u and its inclusive running maximum M.

    XLA on the CPU folds the JAX function's ``X - v - u`` into
    ``X - (v + u)`` (the sum taken once, in f32) and contracts the left
    column's ``v + (m + 1) u`` into one fused multiply-add; both are
    reproduced here and in K6."""
    f32 = torch.float32
    vu = torch.tensor(v, dtype=f32) + torch.tensor(u, dtype=f32)
    colb = torch.tensor(-_fma32(np.float32(m + 1), np.float32(u),
                                np.float32(v)), dtype=f32)
    jglob = _lanes(X, j0)
    n_vec = _n_vec(m, lw, jglob)
    C = torch.cat([torch.full((1,), xin, dtype=f32, device=X.device),
                   X[:-1]]) - vu
    C = torch.where((n_vec == 0.0) & (m < -lw), colb - vu, C)
    T = C + _ju(jglob, u)
    return torch.cummax(T, dim=0).values


def row_close_ref(X, M, carry: float, m: int, j0: int, lw: int, W: int,
                  lb: int, u: float) -> torch.Tensor:
    """Entry point (c): the carried-in maximum of the lanes to the left
    applied, E = M - j u, H0 = max(X, E), masked to the band with
    NEG_SENT."""
    jglob = _lanes(X, j0)
    n_vec = _n_vec(m, lw, jglob)
    M = torch.maximum(M, torch.tensor(carry, dtype=torch.float32))
    E = M - _ju(jglob, u)
    H0 = torch.maximum(X, E)
    valid = (n_vec >= 0) & (n_vec < lb) & (jglob < W)
    return torch.where(valid, H0, NEG_SENT)


def frontier_row_ref(H, G, s_row, recv: tuple, *, m: int, j0: int,
                     lw: int, W: int, lb: int, u: float,
                     v: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One whole row step of a shard, the plain version, with the values
    the exchanges deliver given: ``recv`` = (hedge, gedge, xin, carry).
    Returns the row's H0 and G0."""
    hedge, gedge, xin, carry = recv
    G0, X = row_edges_ref(H, G, s_row, hedge, gedge, u, v)
    M = row_scan_ref(X, xin, m, j0, lw, u, v)
    return row_close_ref(X, M, carry, m, j0, lw, W, lb, u), G0


def _threads(Wl: int) -> int:
    return min(1024, -(-Wl // 32) * 32)


def _require(name, *ts):
    dev = ts[0].device
    Wl = ts[0].shape[0]
    for t in ts:
        _build.require(t, name, torch.float32, (Wl,), dev)


def row_edges(H, G, s_row, hedge: float, gedge: float, u: float,
              v: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Entry point (a): the plain version for CPU tensors, K6 for CUDA
    tensors."""
    if H.device.type == "cpu":
        return row_edges_ref(H, G, s_row, hedge, gedge, u, v)
    G0, X = torch.empty_like(H), torch.empty_like(H)
    _require("frontier row", H, G, s_row, G0, X)
    lib = _build.load()
    err = lib.frontier_edges_launch(
        H.data_ptr(), G.data_ptr(), s_row.data_ptr(), G0.data_ptr(),
        X.data_ptr(), H.shape[0], _threads(H.shape[0]), hedge, gedge, u, v,
        torch.cuda.current_stream(H.device).cuda_stream)
    _build.check(err, "frontier_edges_launch")
    _build.LAUNCHES["frontier_row"] += 1
    return G0, X


def row_scan(X, xin: float, m: int, j0: int, lw: int, u: float,
             v: float) -> torch.Tensor:
    """Entry point (b): the plain version for CPU tensors, K6 for CUDA
    tensors."""
    if X.device.type == "cpu":
        return row_scan_ref(X, xin, m, j0, lw, u, v)
    M = torch.empty_like(X)
    _require("frontier row", X, M)
    lib = _build.load()
    err = lib.frontier_scan_launch(
        X.data_ptr(), M.data_ptr(), X.shape[0], _threads(X.shape[0]), m, j0,
        lw, xin, u, v, torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(err, "frontier_scan_launch")
    _build.LAUNCHES["frontier_row"] += 1
    return M


def row_close(X, M, carry: float, m: int, j0: int, lw: int, W: int, lb: int,
              u: float) -> torch.Tensor:
    """Entry point (c): the plain version for CPU tensors, K6 for CUDA
    tensors."""
    if X.device.type == "cpu":
        return row_close_ref(X, M, carry, m, j0, lw, W, lb, u)
    H0 = torch.empty_like(X)
    _require("frontier row", X, M, H0)
    lib = _build.load()
    err = lib.frontier_close_launch(
        X.data_ptr(), M.data_ptr(), H0.data_ptr(), X.shape[0],
        _threads(X.shape[0]), m, j0, lw, W, lb, carry, u,
        torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(err, "frontier_close_launch")
    _build.LAUNCHES["frontier_row"] += 1
    return H0


def frontier_row(H, G, s_row, recv: tuple, *, m: int, j0: int, lw: int,
                 W: int, lb: int, u: float,
                 v: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``frontier_row_ref``'s step through the three entry points (K6 on
    CUDA tensors)."""
    hedge, gedge, xin, carry = recv
    G0, X = row_edges(H, G, s_row, hedge, gedge, u, v)
    M = row_scan(X, xin, m, j0, lw, u, v)
    return row_close(X, M, carry, m, j0, lw, W, lb, u), G0


class _Ring:
    """The row's exchanges between neighbouring ranks, on host scalars:
    each rank posts its sends and receives together and waits for both."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.ranks = [dist.get_global_rank(group, r)
                      for r in range(self.world)]

    def shift(self, vals: list, step: int, fill: float) -> list:
        """Send ``vals`` to rank + step; return what rank - step sent
        (``fill`` at the end of the line)."""
        src, dst = self.rank - step, self.rank + step
        reqs = []
        got = torch.full((len(vals),), fill, dtype=torch.float32)
        if 0 <= dst < self.world:
            reqs.append(dist.isend(torch.tensor(vals, dtype=torch.float32),
                                   self.ranks[dst], group=self.group))
        if 0 <= src < self.world:
            reqs.append(dist.irecv(got, self.ranks[src], group=self.group))
        for r in reqs:
            r.wait()
        return got.tolist()


def frontier_pairwise_score(a: np.ndarray, b: np.ndarray, lw: int, up: int,
                            u: float, v: float, mtx, group=None, *,
                            device) -> float:
    """Global-mode banded affine score of ONE pair with the band split
    over the ranks of ``group`` (every rank calls it and gets the score;
    ``group=None``: this process alone, with no exchange).  Each rank's
    row steps run on ``device``: the plain version on the CPU, K6 on a
    card.  Exact (modulo f32 reassociation) against the single-device
    row sweep, and bit-equal to the JAX function on a mesh of as many
    devices."""
    la, lb = len(a), len(b)
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    W = up - lw + 1
    q = world * LANE_QUANTUM
    Wp = -(-W // q) * q
    Wl = Wp // world
    j0 = rank * Wl
    s_rows = torch.as_tensor(
        np.ascontiguousarray(band_rows(a, b, lw, mtx, Wp)[:, j0:j0 + Wl]),
        device=device)
    H, G = row_init(j0, Wl, lw, up, u, v, device)
    ring = _Ring(group) if world > 1 else None
    hedge = gedge = xin = NEG_SENT
    carry = NEVSEL
    for m in range(la):
        if ring is not None:
            hedge, gedge = ring.shift(torch.stack([H[0], G[0]]).tolist(),
                                      -1, NEG_SENT)
        G, X = row_edges(H, G, s_rows[m], hedge, gedge, u, v)
        if ring is not None:
            xin, = ring.shift([float(X[Wl - 1])], 1, NEG_SENT)
        M = row_scan(X, xin, m, j0, lw, u, v)
        if ring is not None:
            # the exclusive running maximum of the ranks to the left
            carry, mymax = NEVSEL, float(M[Wl - 1])
            for _ in range(world - 1):
                got, = ring.shift([mymax], 1, NEVSEL)
                carry = max(carry, got)
                mymax = max(mymax, got)
        H = row_close(X, M, carry, m, j0, lw, W, lb, u)
    n_last = (la - 1) + lw + torch.arange(j0, j0 + Wl, device=H.device)
    sc = torch.where(n_last == lb - 1, H, NEVSEL).max().reshape(1).cpu()
    if ring is not None:
        dist.all_reduce(sc, op=dist.ReduceOp.MAX, group=group)
    return float(sc[0])
