"""The multi-device paths on ``torch.distributed``, and the band-frontier
sweep of one long banded pair (kernel K6: K6s and K6r).

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
  holds ``Wl`` lanes.  ``sweep_plan`` picks by width: one rank's band of
  up to ``K6S_MAX_LANES`` lanes is swept in one launch of K6s
  (``frontier_sweep``), with the scores looked up on the card; a ring of
  ranks, or a wider band, runs K6r (``frontier_row``), one launch a row.
  The ring is skewed: rank r computes row m once it holds X's last lane
  and the running maximum of row m from rank r - 1 and the first lanes
  of H and G of row m - 1 from rank r + 1, which meets every dependency
  of the JAX function's three ``ppermute``s and its (world - 1)-hop
  maximum chain, so a row costs one launch, one read of four scalars and
  one message each way.  ``frontier_row_ref`` is the row step's plain
  version, ``frontier_sweep_ref`` the whole sweep's.
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
# K6s: the lanes a thread may hold in registers, the threads a block
# keeps to where 1, 2 or 4 lanes a thread allow it, and the widest band
# one block holds
K6S_LANES_A_THREAD = (1, 2, 4, 8)
K6S_THREADS = 160
K6S_MAX_LANES = 1024 * K6S_LANES_A_THREAD[-1]
# the ring's messages of the last frontier run of a rank (tests read it)
LAST_RING: dict = {}


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


def sweep_plan(Wl: int, world: int = 1) -> dict:
    """How a shard of ``Wl`` lanes is swept on the card.

    K6s (``frontier_sweep``: every row in one launch) takes the band of a
    single rank up to ``K6S_MAX_LANES`` = 8,192 lanes, one block of at
    most 1,024 threads: 1, 2 or 4 lanes a thread in registers, the fewest
    that keep the block within ``K6S_THREADS`` = 160 threads; past that 4
    up to 4,096 lanes, then 8.  (On an H100, ``tools/k6_bench.py``: a row
    costs least at 4 lanes a thread from 520 to 2,056 lanes, and 8 cost
    more than 4 wherever 4 fit.)  K6r (``frontier_row``: one launch a
    row) takes a wider band, and every shard of a ring of two ranks or
    more, whose rows wait for the neighbours' values."""
    if world == 1 and Wl <= K6S_MAX_LANES:
        k = next((k for k in K6S_LANES_A_THREAD[:3]
                  if -(-Wl // k) <= K6S_THREADS),
                 4 if Wl <= 4096 else 8)
        return {"kernel": "sweep", "k": k,
                "threads": -(-Wl // (32 * k)) * 32}
    return {"kernel": "row", "threads": _row_threads(Wl)}


def _row_threads(Wl: int) -> int:
    return min(1024, -(-Wl // 32) * 32)


def band_rows(a, b, lw: int, mtx, Wl: int, j0: int = 0) -> np.ndarray:
    """Band-packed substitution rows of a shard of ``Wl`` lanes from
    ``j0``: s_rows[m, j] = mtx[a[m], b[n]] at column n = m + lw + j0 + j,
    NEG_SENT off the matrix (the JAX function's packing, gathered over the
    band's indices only).  The plain version's scores; K6 looks them up
    on the card."""
    a, b = np.asarray(a), np.asarray(b)
    n = np.arange(len(a))[:, None] + (lw + j0) + np.arange(Wl)[None, :]
    ok = (n >= 0) & (n < len(b))
    s = np.asarray(mtx, np.float32)[a[:, None],
                                    b[np.clip(n, 0, max(len(b) - 1, 0))]]
    return np.where(ok, s, np.float32(NEG_SENT)).astype(np.float32)


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


def frontier_row_ref(H, G, s_row, recv: tuple, *, m: int, j0: int,
                     lw: int, W: int, lb: int, u: float, v: float) -> tuple:
    """One row step of a shard, the plain version, with the values from
    the neighbours given: ``recv`` = (hedge, gedge, xin, carry), the right
    neighbour's first lane of H and G, the left neighbour's last lane of
    X, and the running maximum of the shards to the left.  Returns the
    row's H0 and G0, and the four values it sends on: H0[0] and G0[0] to
    the left neighbour, X[Wl - 1] and max(carry, M[Wl - 1]) to the right.

    XLA on the CPU folds the JAX function's ``X - v - u`` into
    ``X - (v + u)`` (the sum taken once, in f32) and contracts the left
    column's ``v + (m + 1) u`` into one fused multiply-add; both are
    reproduced here and in K6."""
    f32, dev = torch.float32, H.device
    hedge, gedge, xin, carry = recv
    uf, vf = torch.tensor(u, dtype=f32), torch.tensor(v, dtype=f32)

    def cat(x, edge, first):
        e = torch.full((1,), edge, dtype=f32, device=dev)
        return torch.cat([e, x] if first else [x, e])
    G0 = torch.maximum(cat(H[1:], hedge, False) - vf,
                       cat(G[1:], gedge, False)) - uf
    X = torch.maximum(H + s_row, G0)
    vu = vf + uf
    colb = torch.tensor(-_fma32(np.float32(m + 1), np.float32(u),
                                np.float32(v)), dtype=f32)
    jglob = torch.arange(j0, j0 + H.shape[0], device=dev)
    # (m + lw) + jglob, in f32: the JAX function's order
    n_vec = (torch.tensor(float(m), dtype=f32) + float(lw)) + jglob.to(f32)
    C = cat(X[:-1], xin, True) - vu
    C = torch.where((n_vec == 0.0) & (m < -lw), colb - vu, C)
    ju = jglob.to(f32) * uf
    M = torch.maximum(torch.cummax(C + ju, dim=0).values,
                      torch.tensor(carry, dtype=f32))
    H0 = torch.where((n_vec >= 0) & (n_vec < lb) & (jglob < W),
                     torch.maximum(X, M - ju), NEG_SENT)
    return H0, G0, torch.stack([H0[0], G0[0], X[-1], M[-1]])


def frontier_sweep_ref(H, G, a, b, mtx, *, lw: int, W: int, u: float,
                       v: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole band of one rank, the plain version: ``frontier_row_ref``
    row after row with nothing received, on ``band_rows``' scores.
    Returns the last row's H and G."""
    s_rows = torch.as_tensor(band_rows(a.cpu(), b.cpu(), lw, mtx.cpu(),
                                       H.shape[0]), device=H.device)
    recv = (NEG_SENT, NEG_SENT, NEG_SENT, NEVSEL)
    for m in range(a.shape[0]):
        H, G, _ = frontier_row_ref(H, G, s_rows[m], recv, m=m, j0=0, lw=lw,
                                   W=W, lb=b.shape[0], u=u, v=v)
    return H, G


def _require(name, H, G, outs, a, b, mtx):
    Wl, dev = H.shape[0], H.device
    for t in (H, G, *outs):
        _build.require(t, name, torch.float32, (Wl,), dev)
    _build.require(a, name, torch.int32, (a.shape[0],), dev)
    _build.require(b, name, torch.int32, (b.shape[0],), dev)
    _build.require(mtx, name, torch.float32, (mtx.shape[0],) * 2, dev)


def frontier_sweep(H, G, a, b, mtx, *, lw: int, W: int, u: float, v: float,
                   plan: dict | None = None) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """K6s: every row of one rank's band in one launch, from the virtual
    row's H and G; ``a``, ``b`` (int32 codes) and ``mtx`` on the same
    device.  Returns the last row's H and G.  The plain version for CPU
    tensors; on CUDA tensors K6s or an error."""
    if H.device.type == "cpu":
        return frontier_sweep_ref(H, G, a, b, mtx, lw=lw, W=W, u=u, v=v)
    plan = sweep_plan(H.shape[0]) if plan is None else plan
    if plan["kernel"] != "sweep":
        raise ValueError(f"K6s holds at most {K6S_MAX_LANES} lanes, not "
                         f"{H.shape[0]}")
    Ho, Go = torch.empty_like(H), torch.empty_like(H)
    _require("frontier sweep", H, G, (Ho, Go), a, b, mtx)
    lib = _build.load()
    err = lib.frontier_sweep_launch(
        H.data_ptr(), G.data_ptr(), Ho.data_ptr(), Go.data_ptr(),
        a.data_ptr(), b.data_ptr(), mtx.data_ptr(), mtx.shape[0],
        a.shape[0], b.shape[0], H.shape[0], lw, W, plan["k"],
        plan["threads"], u, v, torch.cuda.current_stream(H.device).cuda_stream)
    _build.check(err, "frontier_sweep_launch")
    _build.LAUNCHES["frontier_sweep"] += 1
    return Ho, Go


def frontier_row(H, G, a, b, mtx, recv: tuple, *, m: int, j0: int, lw: int,
                 W: int, u: float, v: float) -> tuple:
    """K6r: one row step of a shard (``frontier_row_ref``'s), the scores
    of row ``m`` looked up from ``a``, ``b`` and ``mtx``.  The plain
    version for CPU tensors; on CUDA tensors K6r or an error."""
    Wl = H.shape[0]
    if H.device.type == "cpu":
        s_row = torch.as_tensor(band_rows(a[m:m + 1], b, lw + m, mtx, Wl,
                                          j0)[0])
        return frontier_row_ref(H, G, s_row, recv, m=m, j0=j0, lw=lw, W=W,
                                lb=b.shape[0], u=u, v=v)
    if not 0 <= m < a.shape[0]:
        raise ValueError(f"row {m} is outside 0 .. {a.shape[0] - 1}")
    H0, G0 = torch.empty_like(H), torch.empty_like(H)
    sends = torch.empty(4, dtype=torch.float32, device=H.device)
    _require("frontier row", H, G, (H0, G0), a, b, mtx)
    hedge, gedge, xin, carry = recv
    lib = _build.load()
    err = lib.frontier_row_launch(
        H.data_ptr(), G.data_ptr(), H0.data_ptr(), G0.data_ptr(),
        sends.data_ptr(), a.data_ptr(), b.data_ptr(), mtx.data_ptr(),
        mtx.shape[0], m, j0, b.shape[0], Wl, lw, W, _row_threads(Wl), hedge,
        gedge, xin, carry, u, v,
        torch.cuda.current_stream(H.device).cuda_stream)
    _build.check(err, "frontier_row_launch")
    _build.LAUNCHES["frontier_row"] += 1
    return H0, G0, sends


class _Ring:
    """The skewed ring's messages between neighbouring ranks, on host
    tensors: from the left, X's last lane and the running maximum of each
    row (``la`` messages); from the right, the first lanes of H and G of
    each row but the last (``la - 1``).  Each receive is posted a message
    ahead, so no send waits for its receiver."""

    def __init__(self, group, la: int):
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        self.group = group
        self.peer = {"left": dist.get_global_rank(group, rank - 1)
                     if rank > 0 else None,
                     "right": dist.get_global_rank(group, rank + 1)
                     if rank + 1 < world else None}
        self.expect = {"left": la, "right": la - 1}
        self.count = {"sent_left": 0, "sent_right": 0, "recv_left": 0,
                      "recv_right": 0}
        self._recv, self._sent = {}, {}
        for side in self.peer:
            self._post(side)

    def _post(self, side: str) -> None:
        if self.peer[side] is not None and self.expect[side] > 0:
            self.expect[side] -= 1
            buf = torch.empty(2, dtype=torch.float32)
            self._recv[side] = (dist.irecv(buf, self.peer[side],
                                           group=self.group), buf)

    def recv(self, side: str) -> list:
        """The next two values from the neighbour on ``side``."""
        work, buf = self._recv.pop(side)
        work.wait()
        self.count[f"recv_{side}"] += 1
        self._post(side)
        return buf.tolist()

    def send(self, side: str, vals: list) -> None:
        """Two values to the neighbour on ``side``."""
        if side in self._sent:
            self._sent.pop(side)[0].wait()
        buf = torch.tensor(vals, dtype=torch.float32)
        self._sent[side] = (dist.isend(buf, self.peer[side],
                                       group=self.group), buf)
        self.count[f"sent_{side}"] += 1

    def close(self) -> None:
        for work, _ in self._sent.values():
            work.wait()


def _rows(H, G, a, b, mtx, group, *, j0: int, lw: int, up: int, W: int,
          u: float, v: float) -> torch.Tensor:
    """Every row of a shard through K6r (``frontier_row``), on the skewed
    ring of ``group``'s ranks (None: one rank alone).  Returns the last
    row's H."""
    la, Wl = a.shape[0], H.shape[0]
    ring = _Ring(group, la) if group is not None and \
        dist.get_world_size(group) > 1 else None
    hedge = gedge = xin = NEG_SENT
    carry = NEVSEL
    if ring is not None and ring.peer["right"] is not None:
        # the right neighbour's first lane on the virtual row
        hr, gr = row_init(j0 + Wl, 1, lw, up, u, v, "cpu")
        hedge, gedge = float(hr[0]), float(gr[0])
    reads = 0
    for m in range(la):
        if ring is not None:
            if ring.peer["left"] is not None:
                xin, carry = ring.recv("left")
            if m > 0 and ring.peer["right"] is not None:
                hedge, gedge = ring.recv("right")
        H, G, sends = frontier_row(H, G, a, b, mtx, (hedge, gedge, xin,
                                                     carry),
                                   m=m, j0=j0, lw=lw, W=W, u=u, v=v)
        if ring is not None:
            out = sends.tolist()
            reads += 1
            if ring.peer["left"] is not None and m + 1 < la:
                ring.send("left", out[:2])
            if ring.peer["right"] is not None:
                ring.send("right", out[2:])
    if ring is not None:
        ring.close()
        LAST_RING.update(ring.count, rows=la, reads=reads)
    return H


def frontier_pairwise_score(a: np.ndarray, b: np.ndarray, lw: int, up: int,
                            u: float, v: float, mtx, group=None, *,
                            device) -> float:
    """Global-mode banded affine score of ONE pair with the band split
    over the ranks of ``group`` (every rank calls it and gets the score;
    ``group=None``: this process alone, with no exchange).  Each rank's
    rows run on ``device``: the plain versions on the CPU, K6s or K6r on
    a card (``sweep_plan``).  Exact (modulo f32 reassociation) against the
    single-device row sweep, and bit-equal to the JAX function on a mesh
    of as many devices."""
    la, lb = len(a), len(b)
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    W = up - lw + 1
    q = world * LANE_QUANTUM
    Wl = -(-W // q) * q // world
    j0 = rank * Wl
    LAST_RING.clear()
    H, G = row_init(j0, Wl, lw, up, u, v, device)
    at = torch.as_tensor(np.asarray(a, np.int32), device=device)
    bt = torch.as_tensor(np.asarray(b, np.int32), device=device)
    mt = torch.as_tensor(np.asarray(mtx, np.float32), device=device)
    plan = sweep_plan(Wl, world)
    if plan["kernel"] == "sweep":
        H, _ = frontier_sweep(H, G, at, bt, mt, lw=lw, W=W, u=u, v=v,
                              plan=plan)
    else:
        H = _rows(H, G, at, bt, mt, group, j0=j0, lw=lw, up=up, W=W, u=u,
                  v=v)
    n_last = (la - 1) + lw + torch.arange(j0, j0 + Wl, device=H.device)
    sc = torch.where(n_last == lb - 1, H, NEVSEL).max().reshape(1).cpu()
    if world > 1:
        dist.all_reduce(sc, op=dist.ReduceOp.MAX, group=group)
    return float(sc[0])
