"""The band-frontier sweep's plain versions (K6s's and K6r's) on the CPU
against the JAX package's ``frontier_pairwise_score`` on a mesh of one
device, the band-only packing of the scores against the full matrix's,
and the width plan that picks between the two kernels."""

import numpy as np
import pytest
import torch

from prrn_aln_tpu_torch.ops import frontier

from test_torch_distributed import FRONTIER, _bits, _jax_mesh

torch.set_num_threads(1)

# test_torch_distributed.py's pairs, and one whose band holds the left
# column for 1,060 lanes (more than one chunk of 1,024 lanes, the widest
# block, and many warps' lanes)
PAIRS = {**FRONTIER, "wide_left": (1100, 1050, -1060, 40, 0.7111, 3.3, 5,
                                   0.0)}


def _case(name):
    la, lb, lw, up, u, v, seed, shift = PAIRS[name]
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 24, la).astype(np.int32)
    b = rng.integers(0, 24, lb).astype(np.int32)
    mtx = (rng.normal(0, 2, (26, 26)) + shift).astype(np.float32)
    return a, b, lw, up, u, v, mtx


def _widths(lw, up, world):
    q = world * frontier.LANE_QUANTUM
    Wp = -(-(up - lw + 1) // q) * q
    return Wp, Wp // world


@pytest.mark.parametrize("name", list(PAIRS))
def test_band_rows_matches_full_matrix(name):
    """``band_rows`` gathers only the band, bit-equal to the JAX
    function's packing from the whole la x lb matrix, for the whole band
    and for each shard of two and four ranks."""
    a, b, lw, up, u, v, mtx = _case(name)
    S = mtx[a[:, None], b[None, :]]
    for world in (1, 2, 4):
        Wp, Wl = _widths(lw, up, world)
        jj = np.arange(Wp)
        want = np.full((len(a), Wp), frontier.NEG_SENT, np.float32)
        n_idx = np.arange(len(a))[:, None] + lw + jj[None, :]
        ok = (n_idx >= 0) & (n_idx < len(b))
        mg, jg = np.nonzero(ok)
        want[mg, jg] = S[mg, n_idx[mg, jg]]
        for rank in range(world):
            got = frontier.band_rows(a, b, lw, mtx, Wl, rank * Wl)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(
                _bits(got), _bits(want[:, rank * Wl:(rank + 1) * Wl]))


@pytest.mark.parametrize("name", list(PAIRS))
def test_plain_sweep_matches_jax(name):
    """The plain sweep (``frontier_row_ref`` row after row on
    ``band_rows``' scores) gives the JAX function's score bit for bit."""
    from prrn_aln_tpu.ops.frontier import frontier_pairwise_score as jfps
    a, b, lw, up, u, v, mtx = _case(name)
    _, Wl = _widths(lw, up, 1)
    H, G = frontier.row_init(0, Wl, lw, up, u, v, "cpu")
    H, G = frontier.frontier_sweep_ref(
        H, G, torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(mtx),
        lw=lw, W=up - lw + 1, u=u, v=v)
    n_last = (len(a) - 1) + lw + np.arange(Wl)
    got = np.where(n_last == len(b) - 1, H.numpy(), frontier.NEVSEL).max()
    want = jfps(a, b, lw, up, u, v, mtx, _jax_mesh(1, "band"))
    assert _bits(got) == _bits(want), (got, want)
    assert _bits(frontier.frontier_pairwise_score(
        a, b, lw, up, u, v, mtx, device="cpu")) == _bits(want)


@pytest.mark.parametrize("name", list(FRONTIER))
def test_row_path_matches_sweep(name, monkeypatch):
    """A band past the plan's limit takes the row path (K6r's plain
    version, one row a call, no ring at world 1): the same score bits as
    the sweep."""
    a, b, lw, up, u, v, mtx = _case(name)
    want = frontier.frontier_pairwise_score(a, b, lw, up, u, v, mtx,
                                            device="cpu")
    calls = []
    row = frontier.frontier_row

    def counted(*args, **kw):
        calls.append(kw["m"])
        return row(*args, **kw)
    monkeypatch.setattr(frontier, "K6S_MAX_LANES", frontier.LANE_QUANTUM)
    monkeypatch.setattr(frontier, "frontier_row", counted)
    got = frontier.frontier_pairwise_score(a, b, lw, up, u, v, mtx,
                                           device="cpu")
    assert calls == list(range(len(a)))
    assert frontier.LAST_RING == {}
    assert _bits(got) == _bits(want)


@pytest.mark.parametrize("Wl, world, want", [
    (1, 1, {"kernel": "sweep", "k": 1, "threads": 32}),
    (160, 1, {"kernel": "sweep", "k": 1, "threads": 160}),
    (161, 1, {"kernel": "sweep", "k": 2, "threads": 96}),
    (520, 1, {"kernel": "sweep", "k": 4, "threads": 160}),
    (1032, 1, {"kernel": "sweep", "k": 4, "threads": 288}),
    (4096, 1, {"kernel": "sweep", "k": 4, "threads": 1024}),
    (4097, 1, {"kernel": "sweep", "k": 8, "threads": 544}),
    (8192, 1, {"kernel": "sweep", "k": 8, "threads": 1024}),
    (8193, 1, {"kernel": "row", "threads": 1024}),
    (264, 2, {"kernel": "row", "threads": 288}),
    (8, 4, {"kernel": "row", "threads": 32})])
def test_sweep_plan(Wl, world, want):
    """K6s up to K6S_MAX_LANES lanes of one rank, with the fewest of 1, 2
    or 4 lanes a thread that keep the block within K6S_THREADS threads,
    else 4 up to 4,096 lanes and 8 past that; K6r past K6S_MAX_LANES and
    on every ring."""
    assert frontier.K6S_MAX_LANES == 8192
    plan = frontier.sweep_plan(Wl, world)
    assert plan == want
    if plan["kernel"] == "sweep":
        assert plan["threads"] * plan["k"] >= Wl
