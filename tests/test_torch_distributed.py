"""The port's multi-device paths on ``torch.distributed`` (gloo), with
ranks spawned on the CPU, against the run with no group and against the
JAX package on a virtual device mesh of the same size.

Each world size spawns its ranks once (``torch.multiprocessing``, start
method ``spawn``; a ``FileStore`` in the test's temporary directory, so
parallel test workers never share a port).  Every rank runs every case
with the group and writes what it returned; the parent compares.  The
children import only torch and the port; JAX is imported in the parent,
inside the tests."""

import os
import pickle
import socket
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from prrn_aln_tpu_torch import alphabet as ab, io as pio, pipeline, scoring
from prrn_aln_tpu_torch.config import AlnParams
from prrn_aln_tpu_torch.msa import distance
from prrn_aln_tpu_torch.msa.msa import msa_from_strings
from prrn_aln_tpu_torch.ops import frontier, group as gops, pairwise

torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"
# a hung rendezvous fails the test instead of stalling the suite
JOIN_TIMEOUT_S = 240
# the frontier pairs: test_frontier.py's; one whose u and v are not
# exact in binary (XLA's folded v + u and fused left column matter); and
# one of negative scores only, whose rows fall from row to row (a running
# maximum carried over from an earlier row would show there)
FRONTIER = {"test_frontier": (96, 96, -40, 40, 2.0, 9.0, 9, 0.0),
            "inexact": (200, 190, -60, 70, 0.7111, 3.3, 2, 0.0),
            "negative": (80, 70, -75, 30, 0.377, 5.123, 4, -60.0)}


def _pmtx():
    return scoring.protein_matrix(AlnParams(pam=150))[0]


def _seqs():
    """test_sharding.py's 36 pairs."""
    rng = np.random.default_rng(17)
    return [rng.integers(3, 23, size=rng.integers(30, 70)).astype(np.int32)
            for _ in range(9)]


def _pair_rows():
    """test_sharding.py's five group pairs, as (A rows, B rows)."""
    rows = ["MKVLAAGFDDEERRKKLL", "MKVLAAGFDEEERRKQLL",
            "MKVLAGGFDDEERRKKLL", "MKVLAAGFDDEERRQKLL",
            "MKVLAAGFDDEDRRKKLL", "MKVIAAGFDDEERRKKLL"]
    A, B, C = rows[:3], rows[3:], [r[2:] for r in rows[:2]]
    return [(A, B), (B, C), (A, C), (C, B), (A, B)]


def _pairs(msa_from, alphabet, dim):
    groups = {}

    def prep(rows):
        key = tuple(rows)
        if key not in groups:
            groups[key] = msa_from(rows, alphabet.PROTEIN).prepare(dim)
        return groups[key]
    return [(prep(a), prep(b)) for a, b in _pair_rows()]


def _frontier_case(name):
    la, lb, lw, up, u, v, seed, shift = FRONTIER[name]
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 24, la).astype(np.int32)
    b = rng.integers(0, 24, lb).astype(np.int32)
    mtx = (rng.normal(0, 2, (26, 26)) + shift).astype(np.float32)
    return a, b, lw, up, u, v, mtx


def _cases(group) -> dict:
    """Every case with ``group`` (None: the run with no group)."""
    mtx = _pmtx()
    out = {"scores": distance.all_pairs_scores(_seqs(), mtx, 2.0, 9.0, -60,
                                               group, device="cpu")}
    os.environ["PRRN_PW_FUSED"] = "1"
    try:
        out["scores_fused"] = distance.all_pairs_scores(
            _seqs(), mtx, 2.0, 9.0, -60, group, device="cpu")
    finally:
        del os.environ["PRRN_PW_FUSED"]
    out["batch"] = gops.group_align_batch(
        _pairs(msa_from_strings, ab, mtx.shape[0]), mtx, u=2.0, v=9.0,
        sh=-60, pads=(6, 32), group=group, device="cpu")
    out["shard"] = gops.LAST_BATCH_SHARD
    recs = pio.sniff_and_read(FIX / "dnafam.fa")
    msa = pipeline.build_msa(recs, randseed=0, nbatch=4, group=group,
                             device="cpu")
    out["msa"] = pio.write_native_block(msa)
    out["frontier"], out["ring"] = {}, {}
    for name in FRONTIER:
        out["frontier"][name] = frontier.frontier_pairwise_score(
            *_frontier_case(name), group, device="cpu")
        out["ring"][name] = dict(frontier.LAST_RING)
    return out


def _rank_main(rank, world, store_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        res = _cases(dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


_RUNS = {}


def _ranks(world, tmp_path_factory) -> list[dict]:
    """What every rank of a ``world``-rank run returned (spawned once a
    world size)."""
    if world not in _RUNS:
        tmp = tmp_path_factory.mktemp(f"world{world}")
        ctx = mp.start_processes(_rank_main, args=(world, str(tmp / "store"),
                                                   str(tmp)),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"world {world}: ranks did not finish "
                                       f"in {JOIN_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        _RUNS[world] = [pickle.loads((tmp / f"rank{r}.pkl").read_bytes())
                        for r in range(world)]
    return _RUNS[world]


@pytest.fixture(scope="module")
def alone():
    return _cases(None)


def _jax_mesh(ndev, axis):
    import jax
    from jax.sharding import Mesh
    if len(jax.devices()) < ndev:
        pytest.skip("needs the virtual multi-device CPU mesh")
    return Mesh(np.array(jax.devices()[:ndev]), (axis,))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("world", [2, 4])
def test_all_pairs_scores(world, alone, tmp_path_factory):
    from prrn_aln_tpu.msa import distance as jdistance
    runs = _ranks(world, tmp_path_factory)
    for res in runs:
        np.testing.assert_array_equal(_bits(res["scores"]),
                                      _bits(alone["scores"]))
        np.testing.assert_array_equal(_bits(res["scores_fused"]),
                                      _bits(alone["scores_fused"]))
    want = jdistance.all_pairs_scores(_seqs(), _pmtx(), 2.0, 9.0, -60,
                                      mesh=_jax_mesh(world, "pairs"))
    np.testing.assert_allclose(runs[0]["scores"], want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_group_align_batch(world, alone, tmp_path_factory):
    from prrn_aln_tpu import alphabet as jab
    from prrn_aln_tpu.msa.msa import msa_from_strings as jmsa_from_strings
    from prrn_aln_tpu.ops import group as jgroup
    runs = _ranks(world, tmp_path_factory)
    n = len(_pair_rows())
    per = -(-n // world)
    for rank, res in enumerate(runs):
        start = min(n, rank * per)
        assert res["shard"] == (rank, world, start, min(n, start + per))
        assert [k for s, k in res["batch"]] == [k for s, k in alone["batch"]]
        assert _bits([s for s, k in res["batch"]]).tolist() == \
            _bits([s for s, k in alone["batch"]]).tolist()
    assert alone["shard"] == (0, 1, 0, n)
    mtx = _pmtx()
    want = jgroup.group_align_batch(
        _pairs(jmsa_from_strings, jab, mtx.shape[0]), mtx, u=2.0, v=9.0,
        sh=-60, pads=(6, 32), mesh=_jax_mesh(world, "pairs"))
    for (sw, kw), (sg, kg) in zip(want, runs[0]["batch"]):
        assert kg == kw
        assert sg == pytest.approx(sw, rel=1e-6, abs=1e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_build_msa(world, alone, tmp_path_factory):
    for res in _ranks(world, tmp_path_factory):
        assert res["msa"] == alone["msa"]
    assert alone["msa"].count("dna") >= 6


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", list(FRONTIER))
def test_frontier_pairwise_score(world, name, alone, tmp_path_factory):
    from prrn_aln_tpu.ops.frontier import frontier_pairwise_score as jfps
    a, b, lw, up, u, v, mtx = _frontier_case(name)
    want = jfps(a, b, lw, up, u, v, mtx, _jax_mesh(world, "band"))
    got = ([alone["frontier"][name]] if world == 1 else
           [res["frontier"][name] for res in
            _ranks(world, tmp_path_factory)])
    for g in got:
        assert _bits(g) == _bits(want), (g, want)
    single = float(pairwise.pairwise_scores(
        torch.as_tensor(a[None]), torch.as_tensor(b[None]), len(a), len(b),
        torch.as_tensor(mtx), u, v, lw=np.array([lw]), up=np.array([up]),
        fused=False)[0])
    assert abs(got[0] - single) <= 1e-3 * max(1.0, abs(single))


@pytest.mark.parametrize("world", [2, 4])
def test_frontier_ring_messages(world, alone, tmp_path_factory):
    """The skewed ring: a rank receives each row's two values from the
    left and each row's but the last from the right, sends as many the
    other way, and reads the four values its row sends once a row; an
    end rank sends nothing past the end.  With no group, no ring."""
    for name in FRONTIER:
        la = len(_frontier_case(name)[0])
        assert alone["ring"][name] == {}
        for rank, res in enumerate(_ranks(world, tmp_path_factory)):
            left, right = rank > 0, rank < world - 1
            assert res["ring"][name] == {
                "sent_left": la - 1 if left else 0,
                "sent_right": la if right else 0,
                "recv_left": la if left else 0,
                "recv_right": la - 1 if right else 0,
                "rows": la, "reads": la}, (name, rank)


def test_maybe_init_distributed(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "PRRN_DIST", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert frontier.maybe_init_distributed() is False
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    monkeypatch.setenv("PROCESS_ID", "0")
    try:
        assert frontier.maybe_init_distributed() is True
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_maybe_init_distributed_failure(monkeypatch, capsys):
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PRRN_DIST", "1")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    monkeypatch.setenv("PROCESS_ID", "0")
    for var in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert frontier.maybe_init_distributed() is False
    assert not dist.is_initialized()
    err = capsys.readouterr().err
    assert err.startswith("; torch.distributed init skipped: ")
    assert err.count("\n") == 1
