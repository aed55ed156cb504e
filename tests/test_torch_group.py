"""Port group DP (plain versions of kernels K2 and K3) vs the JAX package.

The same packed inputs go to the JAX scan engine ``_wavefront_core``
(through ``_wavefront_from_profiles``) and to the port's
``group_wavefront`` on CPU tensors: dirs and opens planes must be
identical, scores within rel 1e-5 / abs 1e-3 (test_pallas_group.py's
tolerance), and the traceback must give the same moves as
``_traceback_device``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from prrn_aln_tpu import alphabet as jab, scoring as jscoring
from prrn_aln_tpu.config import AlnParams as JParams
from prrn_aln_tpu.msa import distance as jdistance, tree as jtree
from prrn_aln_tpu.msa.msa import Msa as JMsa, msa_from_strings
from prrn_aln_tpu.ops import group as jg
from prrn_aln_tpu_torch import convert
from prrn_aln_tpu_torch.ops import group as tg
from prrn_aln_tpu_torch.ops.window import Window, stripe

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"
GFIX = json.loads((FIX / "galign_fixtures.json").read_text())
LS3 = json.loads((FIX / "galign_ls3.json").read_text())
MTX, _ = jscoring.protein_matrix(JParams(pam=150))


def _build(fname, weighted):
    info = GFIX["files"][fname]
    m = msa_from_strings(info["rows"], jab.PROTEIN, info["names"])
    if weighted:
        if m.many == 1:
            m.weight = np.array([1.0])
        elif m.many == 2:
            m.weight = np.array([0.5, 0.5])
        else:
            d = jdistance.msa_distance_matrix(m.codes)
            m.weight = jtree.calc_seq_weights(jtree.upgma(d, m.many))
    m.prepare(MTX.shape[0])
    return m


def _case_pair(case):
    A, B = _build(case["a"], "wa" in case), _build(case["b"], "wa" in case)
    return (B, A) if case["swp"] else (A, B)


def _rand_msa(rng, many, L, gap=0.08, weighted=False):
    codes = (rng.integers(0, 20, size=(many, L)) + jab.ALA).astype(np.int8)
    codes[rng.random((many, L)) < gap] = jab.GAP
    codes[:, 0] = jab.ALA + rng.integers(0, 20)
    m = JMsa(codes=codes, molc=jab.PROTEIN,
             names=[f"s{i}" for i in range(many)])
    if weighted:
        m.weight = rng.random(many).astype(np.float64) + 0.5
    m.prepare(MTX.shape[0])
    return m


def _port(m):
    p = convert.msa_from_numpy(m.codes, m.weight, m.names, m.molc, m.eij)
    p.prepare(MTX.shape[0])
    return p


def _compare_planes(pairs, ls3=False, sh=-60, spb=20.0, scale=1.0):
    """Pack with the port, run both engines on the same arrays, compare
    planes, scores and traceback moves."""
    an_pad = max(max(A.many, B.many) for A, B in pairs)
    la_max = lb_max = tg._bucket(max(max(A.length, B.length)
                                     for A, B in pairs))
    for A, B in pairs:
        PA, PB = _port(A), _port(B)
        w = stripe(A.length, B.length, sh)
        nslot = tg._bucket(w.up - w.lw + 3, 128)
        nsteps = tg._bucket(A.length + B.length + 1, 256)
        item = tg._pack_inputs(PA, PB, MTX, 2.0, 9.0, w, an_pad, an_pad,
                               la_max, lb_max, spb=spb, scale=scale,
                               ls=3 if ls3 else 1)
        js, jd, jo = jg._wavefront_from_profiles(
            *(item[k] for k in tg._FIELDS),
            *(np.int32(item[k]) for k in ("la", "lb", "lw", "up")),
            *(np.float32(item[k]) for k in tg._FFIELDS),
            np.int32(item["k1"]), nslot=nslot, nsteps=nsteps, an=an_pad,
            bn=an_pad, la_max=la_max, lb_max=lb_max, ls3=ls3)
        ins = tg.stack_inputs([item], "cpu")
        ts, td, to, _ = tg.group_wavefront(ins, nslot=nslot, nsteps=nsteps,
                                           ls3=ls3)
        np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo))
        assert float(ts[0]) == pytest.approx(float(js), rel=1e-5, abs=1e-3)
        mi = 2 * (la_max + lb_max) + 4
        jm, jc = jg._traceback_device(jd, jo, np.int32(A.length),
                                      np.int32(B.length), np.int32(w.lw),
                                      max_iters=mi)
        tm, tc = tg.traceback(td, to, ins["la"], ins["lb"], ins["lw"],
                              max_iters=mi)
        assert int(tc[0]) == int(jc)
        np.testing.assert_array_equal(tm[0].numpy(), np.asarray(jm))


@pytest.mark.parametrize("k", range(0, 11, 2))
def test_galign_fixture_planes_match_jax(k):
    _compare_planes([_case_pair(c) for c in GFIX["cases"][k:k + 2]])


@pytest.mark.parametrize("k", [0, 2, 4])
def test_ls3_fixture_planes_match_jax(k):
    _compare_planes([_case_pair(c) for c in LS3["cases"][k:k + 2]],
                    ls3=True)


@pytest.mark.parametrize("seed,weighted,sh,scale,ls3", [
    (11, False, -60, 1.0, False), (5, True, -30, 2.5, False),
    (17, True, -60, 1.0, False), (19, True, -60, 1.0, True),
    (29, True, -40, 1.5, True)])
def test_random_gapped_batch_matches_jax(seed, weighted, sh, scale, ls3):
    rng = np.random.default_rng(seed)
    pairs = [(_rand_msa(rng, int(rng.integers(1, 5)),
                        int(rng.integers(40, 80)), weighted=weighted),
              _rand_msa(rng, int(rng.integers(1, 5)),
                        int(rng.integers(40, 80)), weighted=weighted))
             for _ in range(2)]
    _compare_planes(pairs, ls3=ls3, sh=sh, scale=scale)


@pytest.mark.parametrize("many", [4, 8])
def test_uniform_collapse_matches_jax(many):
    """Gap-free weighted groups collapse to one effective member
    (test_uniform_tier.py)."""
    rng = np.random.default_rng(11)

    def gapfree(L):
        m = JMsa(codes=rng.integers(3, 23, (many, L)).astype(np.int8),
                 molc=jab.PROTEIN, names=[f"s{i}" for i in range(many)],
                 weight=rng.uniform(0.5, 1.5, many))
        m.prepare(MTX.shape[0])
        return m

    A, B = gapfree(90), gapfree(100)
    assert tg.uniform_side(_port(A)) and jg.uniform_side(A)
    want = jg.group_align(A, B, MTX, u=2.0, v=9.0)
    got = tg.group_align(_port(A), _port(B), MTX, u=2.0, v=9.0,
                         device="cpu")
    assert got[1] == want[1]
    assert got[0] == pytest.approx(want[0], rel=1e-5, abs=1e-3)


def test_corner_miss_retry_matches_jax():
    """A band that misses the end corner leaves the score at the sentinel;
    the alignment is redone at sh=-100, as in the JAX package."""
    rng = np.random.default_rng(2)
    a = _rand_msa(rng, 2, 60)
    b = _rand_msa(rng, 3, 60)
    off = Window(lw=5, up=12, width=10)       # lb - la = 0 lies outside
    raw = tg.group_align(_port(a), _port(b), MTX, u=2.0, v=9.0, wdw=off,
                         pads=(3, 64), device="cpu", _retried=True)
    assert raw[0] <= tg.NEVSEL / 2
    want = jg.group_align(a, b, MTX, u=2.0, v=9.0, wdw=off, pads=(3, 64))
    got = tg.group_align(_port(a), _port(b), MTX, u=2.0, v=9.0, wdw=off,
                         pads=(3, 64), device="cpu")
    assert got[1] == want[1]
    assert got[0] == pytest.approx(want[0], rel=1e-5, abs=1e-3)
    assert got[0] > tg.NEVSEL / 2


def test_batch_matches_pallas_interpret():
    """group_align_batch on CPU tensors against the JAX batch on the
    Pallas group kernel in interpret mode, on 2 small pairs."""
    rng = np.random.default_rng(23)
    pairs = [(_rand_msa(rng, 3, 40, weighted=True),
              _rand_msa(rng, 2, 48, weighted=True)) for _ in range(2)]
    jg.USE_PALLAS_GROUP = True
    try:
        want = jg.group_align_batch(pairs, MTX, u=2.0, v=9.0, sh=-60,
                                    pads=(3, 64))
    finally:
        jg.USE_PALLAS_GROUP = None
    got = tg.group_align_batch([(_port(A), _port(B)) for A, B in pairs],
                               MTX, u=2.0, v=9.0, sh=-60, pads=(3, 64),
                               device="cpu")
    for (sw, kw), (sg, kg) in zip(want, got):
        assert kg == kw
        assert sg == pytest.approx(sw, rel=1e-5, abs=1e-3)


def _trim_batch(rng, counts, pad, ls3=False, lens=(40, 80)):
    """Packed inputs of pairs of groups with the given real member counts,
    every side padded to ``pad`` members (zero-weight phantoms)."""
    pairs = [(_port(_rand_msa(rng, a, int(rng.integers(*lens)),
                              weighted=True)),
              _port(_rand_msa(rng, b, int(rng.integers(*lens)),
                              weighted=True)))
             for a, b in counts]
    la_max = lb_max = tg._bucket(max(max(A.length, B.length)
                                     for A, B in pairs))
    wd = [stripe(A.length, B.length, -60) for A, B in pairs]
    nslot = tg._bucket(max(w.up - w.lw + 3 for w in wd), 128)
    nsteps = tg._bucket(max(A.length + B.length + 1 for A, B in pairs), 256)
    items = [tg._pack_inputs(A, B, MTX, 2.0, 9.0, w, pad, pad, la_max,
                             lb_max, spb=20.0, ls=3 if ls3 else 1)
             for (A, B), w in zip(pairs, wd)]
    return items, dict(nslot=nslot, nsteps=nsteps, ls3=ls3)


@pytest.mark.parametrize("counts,pad,ls3", [
    ([(1, 7), (7, 1), (3, 4), (2, 2), (6, 5)], 7, False),
    ([(1, 18), (9, 10)], 19, False),
    ([(1, 6), (4, 3), (5, 5)], 7, True)])
def test_per_pair_trim_is_exact(counts, pad, ls3):
    """The plain version on a padded batch equals each pair run alone on
    arrays cut to its own real members, bit for bit: K2 walks each pair's
    real members only, which is this trim."""
    items, kw = _trim_batch(np.random.default_rng(41), counts, pad, ls3)
    ins = tg.stack_inputs(items, "cpu")
    assert tg.member_counts(ins["wa"]).tolist() == [a for a, _ in counts]
    assert tg.member_counts(ins["wb"]).tolist() == [b for _, b in counts]
    score, dirs, opens, _ = tg.group_wavefront_ref(ins, **kw)
    for p, (a, b) in enumerate(counts):
        one = {k: v[p:p + 1] for k, v in ins.items()}
        for k in ("na_a", "gda", "pga"):
            one[k] = one[k][:, :, :a].contiguous()
        for k in ("na_b", "gdb", "pgb"):
            one[k] = one[k][:, :, :b].contiguous()
        one["wa"], one["wb"] = one["wa"][:, :a], one["wb"][:, :b]
        s1, d1, o1, _ = tg.group_wavefront_ref(one, **kw)
        assert torch.equal(d1[0], dirs[p]) and torch.equal(o1[0], opens[p])
        assert torch.equal(s1.view(torch.int32), score[p:p + 1].view(
            torch.int32))


@pytest.mark.parametrize("an,bn,nslot,lmax,ls3,want", [
    (1, 1, 640, 576, False, "shared"),      # a ce13a17 leaf merge
    (18, 1, 768, 1088, False, "shared"),    # fam19's last refinement
    (10, 9, 768, 1088, True, "shared"),
    (19, 19, 768, 1088, False, "shared"),   # 203,976 bytes
    (40, 24, 640, 384, False, "global"),    # runs of 245,760 bytes
    (20, 20, 768, 1088, True, "global"),    # five lanes
    (2, 2, 640, 16384, False, "global"),    # a run could pass int16
    (2, 2, 640, 16383, False, "shared"),
    (1, 1, 6272, 5248, False, "global"),    # 232,064 bytes of values
    (1, 1, 6400, 5312, False, "cluster"),   # 5.3 kb a side at sh=-60
    (1, 1, 24064, 20032, False, "cluster"),  # 20 kb a side
    (3, 3, 6400, 5312, True, "cluster"),
    (20, 20, 24064, 20032, False, "cluster"),  # runs in device memory
    (1, 1, 110000, 91664, False, "wide")])  # past one cluster
def test_wavefront_variant_rule(an, bn, nslot, lmax, ls3, want):
    """Shared, global, cluster, wide: the first whose shared memory
    fits (the cluster variant's: a CTA's)."""
    variant, smem = tg.wavefront_variant(an, bn, nslot, lmax, lmax, ls3)
    assert variant == want
    runs = 2 * (5 if ls3 else 3) * (an + bn) * (nslot + 2)
    vals = 21 * nslot + 4 * tg.K2_SPAN * (nslot // 2)
    shape = tg.cluster_shape(an, bn, nslot, lmax, lmax, ls3)
    assert smem == {"shared": vals + runs, "global": vals,
                    "cluster": shape and shape["smem_bytes"],
                    "wide": 0}[want]
    assert smem <= tg.SMEM_MAX
    if want in ("cluster", "wide"):
        assert vals > tg.SMEM_MAX
    if want == "wide":
        assert shape is None


@pytest.mark.parametrize("an,bn,nslot,lmax,variant", [
    (40, 24, 640, 384, "shared"),           # runs past shared memory
    (2, 2, 640, 16384, "shared"),           # a run could pass int16
    (1, 1, 6400, 5312, "global"),           # values past shared memory
    (1, 1, 110000, 91664, "cluster"),       # past one cluster of 16
    (1, 1, 640, 512, "rows")])
def test_wavefront_variant_refuses(an, bn, nslot, lmax, variant):
    with pytest.raises(ValueError):
        tg.wavefront_variant(an, bn, nslot, lmax, lmax, False, variant)


def test_wavefront_variant_asked():
    """A variant that fits is taken when asked for, and wide always
    fits."""
    for v in ("shared", "global", "cluster", "wide"):
        assert tg.wavefront_variant(2, 2, 640, 512, 512, True, v)[0] == v


@pytest.mark.parametrize("an,bn,nslot,lmax,ls3,ctas,want", [
    (1, 1, 6400, 5312, False, None, (7, "shared16")),
    (1, 1, 24064, 20032, False, None, (16, "shared32")),  # a run past int16
    (3, 3, 6400, 5312, True, None, (7, "shared16")),
    (20, 20, 24064, 20032, False, None, (16, "device")),
    (20, 20, 6400, 5312, False, None, (8, "shared16")),  # more CTAs: fit
    (1, 1, 7296, 6080, False, None, (8, "shared16")),   # the DNA family
    (40, 40, 6400, 16384, False, None, (7, "device")),  # runs past 16 CTAs
    (1, 1, 99999, 83000, False, None, (16, "device")),
    (1, 1, 181, 150, False, 2, (2, "shared16")),        # an odd band, asked
    (2, 3, 301, 250, True, 3, (3, "shared16")),
    (1, 1, 6400, 5312, False, 4, (4, "shared16"))])
def test_cluster_plan_slices(an, bn, nslot, lmax, ls3, ctas, want):
    """The cluster variant's plan: the slices of whole slot pairs cover
    every slot once, in order; a CTA's bytes fit in ``SMEM_MAX``; at most
    16 CTAs, and one or two live slots a thread by default."""
    shape = tg.cluster_shape(an, bn, nslot, lmax, lmax, ls3, ctas)
    assert (shape["ctas"], shape["runs"]) == want
    assert 1 <= shape["ctas"] <= tg.K2_CLUSTER_MAX
    assert shape["smem_bytes"] <= tg.SMEM_MAX
    slices = tg.cluster_slices(nslot, shape["ctas"])
    covered = [k for s0, s1 in slices for k in range(s0, s1)]
    assert covered == list(range(nslot))
    assert all(s0 % 2 == 0 and s1 > s0 and s1 - s0 <= shape["slots_per_cta"]
               for s0, s1 in slices)
    assert shape["threads"] % 32 == 0 and shape["threads"] <= tg.K2_THREADS
    if ctas is None and shape["ctas"] < tg.K2_CLUSTER_MAX:
        assert shape["pairs_per_cta"] <= 2 * shape["threads"]
    rows = (5 if ls3 else 3) * (an + bn)
    n2 = shape["slots_per_cta"] + 2
    assert shape["smem_bytes"] == (
        4 * tg.K2_SPAN * shape["pairs_per_cta"] + 21 * n2
        + {"shared16": 2, "shared32": 4, "device": 0}[shape["runs"]]
        * rows * n2)
    if ctas is None and shape["ctas"] > 1:   # the fewest CTAs that fit
        fewer = shape["ctas"] - 1
        alt = tg.cluster_shape(an, bn, nslot, lmax, lmax, ls3, fewer)
        assert (alt is None or alt["runs"] != shape["runs"]
                or alt["pairs_per_cta"] > tg.K2_THREADS)


def test_cluster_plan_reported():
    """``wavefront_plan`` reports the cluster variant's CTAs, slots a CTA
    and where the runs live; a size asked for is taken."""
    items, kw = _trim_batch(np.random.default_rng(43), [(1, 18), (9, 10)],
                            19)
    ins = tg.stack_inputs(items, "cpu")
    plan = tg.wavefront_plan(ins, nslot=kw["nslot"], variant="cluster",
                             ctas=3)
    assert (plan["variant"], plan["ctas"], plan["runs"]) == (
        "cluster", 3, "shared16")
    assert plan["slots_per_cta"] == 2 * -(-((kw["nslot"] + 1) // 2) // 3)
    default = tg.wavefront_plan(ins, nslot=kw["nslot"])
    assert (default["variant"], default["ctas"]) == ("shared", 1)


def test_wavefront_plan_counts_real_pairs():
    items, kw = _trim_batch(np.random.default_rng(43), [(1, 18), (9, 10)],
                            19)
    ins = tg.stack_inputs(items, "cpu")
    plan = tg.wavefront_plan(ins, nslot=kw["nslot"])
    assert plan["real_pairs"] == [18, 90]
    assert plan["padded_pairs"] == 361
    assert (plan["an_max"], plan["bn_max"]) == (9, 18)
    assert plan["variant"] == "shared"


def test_member_counts_of_a_collapsed_side():
    """A gap-free side collapses to one effective member of weight 1."""
    rng = np.random.default_rng(11)
    m = JMsa(codes=rng.integers(3, 23, (4, 50)).astype(np.int8),
             molc=jab.PROTEIN, names=[f"s{i}" for i in range(4)],
             weight=rng.uniform(0.5, 1.5, 4))
    m.prepare(MTX.shape[0])
    b = _rand_msa(rng, 3, 50, weighted=True)
    w = stripe(50, 50, -60)
    item = tg._pack_inputs(_port(m), _port(b), MTX, 2.0, 9.0, w, 7, 7, 64,
                           64)
    ins = tg.stack_inputs([item], "cpu")
    assert tg.member_counts(ins["wa"]).tolist() == [1]
    assert tg.member_counts(ins["wb"]).tolist() == [3]


@pytest.mark.parametrize("nsteps,nslot,max_iters,want,rows", [
    (256, 128, 516, "staged", 255),      # a refinement candidate: one tile
    (1280, 640, 2308, "staged", 51),     # a ce13a17 merge
    (1280, 768, 4356, "staged", 42),     # fam19's last refinement
    (2304, 2100, 4356, "staged", 15),    # an sh=-100 retry
    (8192, 7116, 4356, "staged", 8),     # the widest band staged
    (8192, 7117, 4356, "window", 64),    # 8 rows no longer fit
    (2, 64, 8, "staged", 1),             # planes of one row
    (12032, 7296, 24004, "window", 64),  # the 6 kb DNA family's merges
    (40064, 24064, 80004, "window", 64),  # the 20 kb DNA pair
    (12, 30000, 80004, "window", 11),    # a window of fewer rows
])
def test_traceback_plan_rule(nsteps, nslot, max_iters, want, rows):
    """K3's tiles: K3_TILE_BYTES of a plane (at least K3_MIN_ROWS rows, at
    most the plane's rows), four buffers and the moves within SMEM_MAX;
    the window variant where K3_MIN_ROWS rows do not fit, whatever the
    band's width or the walk's length."""
    plan = tg.traceback_plan(nsteps, nslot, max_iters)
    assert (plan["variant"], plan["tile_rows"]) == (want, rows)
    if want == "staged":
        cap = plan["width"]
        assert cap % 128 == 0 and cap >= rows * nslot + 32
        assert plan["smem_bytes"] == tg.K3_HEAD + 4 * cap + max_iters
        assert plan["smem_bytes"] <= tg.SMEM_MAX
        # one more row would not fit, or the tile already has its bytes
        more = tg.K3_HEAD + 4 * tg._k3_cap(rows + 1, nslot) + max_iters
        assert (more > tg.SMEM_MAX or rows == nsteps - 1
                or (rows + 1) * nslot > tg.K3_TILE_BYTES)
    else:
        # rows x a window of 2 rows + 32 slots, rounded out to 16 bytes,
        # of both planes in each stage; no move in shared memory
        assert plan["width"] == -(-(2 * rows + 32) // 16) * 16
        assert plan["stages"] == tg.K3_WINDOW_STAGES
        assert plan["smem_bytes"] == (tg.K3_HEAD + 2 * plan["stages"] * rows
                                      * plan["width"])
        assert plan["smem_bytes"] <= tg.SMEM_MAX


@pytest.mark.parametrize("args,kw", [
    ((1280, 640, 2308), {"tile_rows": 90}),          # past shared memory
    ((1280, 640, 2308), {"tile_rows": 0}),
    ((1280, 640, 2308), {"variant": "staged", "tile_rows": -3}),
    ((8192, 7117, 4356), {"variant": "staged", "tile_rows": 8}),
    ((1280, 640, 2308), {"variant": "global", "tile_rows": 16}),
    ((1280, 640, 2308), {"variant": "rows"}),
    ((0, 640, 2308), {}),
    ((1280, 0, 2308), {}),
    ((1280, 640, 0), {}),
    ((1280, 640, 240000), {"variant": "staged"}),    # moves past the room
    ((65536, 32768, 4356), {}),                     # 2**31 bytes a pair
    ((1280, 640, 2308), {"variant": "window", "stages": 1}),
    ((1280, 640, 2308), {"variant": "window", "stages": 5}),
    ((1280, 640, 2308), {"variant": "window", "width": 40}),
    ((1280, 640, 2308), {"variant": "window", "tile_rows": 0}),
    ((1280, 640, 2308), {"variant": "window", "tile_rows": 900}),
    ((1280, 640, 2308), {"variant": "staged", "width": 64}),
    ((1280, 640, 2308), {"variant": "global", "stages": 2}),
])
def test_traceback_plan_refuses(args, kw):
    with pytest.raises(ValueError):
        tg.traceback_plan(*args, **kw)


def test_traceback_plan_asked_tiles():
    plan = tg.traceback_plan(1280, 640, 2308, tile_rows=16)
    assert (plan["variant"], plan["tile_rows"], plan["width"]) == (
        "staged", 16, 10368)
    assert tg.traceback_plan(1280, 640, 2308, variant="global") == {
        "variant": "global", "tile_rows": 0, "width": 0, "smem_bytes": 0}


def test_traceback_plan_asked_window():
    """The window variant on any planes when asked for (ce13a17's merge
    shape), with its tiles, window and stages as asked."""
    plan = tg.traceback_plan(1280, 640, 2308, variant="window")
    assert (plan["variant"], plan["tile_rows"], plan["width"],
            plan["stages"]) == ("window", 64, 160, 3)
    plan = tg.traceback_plan(1280, 640, 2308, variant="window", tile_rows=8,
                             width=64, stages=4)
    assert (plan["tile_rows"], plan["width"], plan["stages"],
            plan["smem_bytes"]) == (8, 64, 4, tg.K3_HEAD + 2 * 4 * 8 * 64)
