"""The port's fwd2s engine (``ops/spliced_s.py``) on the CPU against the
JAX package's f32 scan engine (``prrn_aln_tpu/ops/spliced_jax.py``):
the same numpy inputs through ``spliced_align_device`` of both, on the
cases of ``tests/test_spliced_jax.py`` (random genes, seeds 0-3, global
ends, mismatches), gen1 x cdna1, gen2 x cdna2 and a gene whose introns
pass DEF_RLMT = 825 nt (the intron penalty's log tail).

Checks: the event and junction planes, the final H band and the SKL
exactly equal, and the score within 0 f32 ulp: the port's penalty table
(``penalty_by_length``) repeats the compiled ``jnp.log``'s operations,
so even the log tail agrees bit for bit.  The JAX sweep's planes are
taken by wrapping ``spliced_jax._sweep`` for the call."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prrn_aln_tpu import alphabet as jab, scoring as jscoring
from prrn_aln_tpu.config import default_params as jdefault_params
from prrn_aln_tpu.ops import spliced_jax as SJ
from prrn_aln_tpu.ops.window import stripe
from prrn_aln_tpu.splice.penalty import IntronPenalty as JIntronPenalty
from prrn_aln_tpu.splice.signals import SpliceSignals as JSpliceSignals
from prrn_aln_tpu_torch.ops import spliced_s as SS
from prrn_aln_tpu_torch.splice.penalty import IntronPenalty
from prrn_aln_tpu_torch.splice.signals import SpliceSignals
from prrn_aln_tpu_torch import alphabet as ab
from test_spliced_jax import _mk_gene

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"


def _fasta(name):
    return "".join(line.strip() for line in
                   (FIX / name).read_text().splitlines()
                   if not line.startswith(">"))


def _mismatch_gene():
    rng = np.random.default_rng(11)
    gen, cdna = _mk_gene(rng)
    c = list(cdna)
    for p in rng.integers(0, len(c), 6):
        c[p] = "ACGT"[rng.integers(0, 4)]
    del c[10:13]
    return gen, "".join(c)


# name -> (genome, cDNA, exga, exgb)
ENDS = ((True, True), (True, True))
CASES = {
    **{f"seed{s}": (*_mk_gene(np.random.default_rng(s)), *ENDS)
       for s in range(4)},
    "global_ends": (*_mk_gene(np.random.default_rng(7), nexon=2),
                    (False, False), (False, False)),
    "mismatches": (*_mismatch_gene(), *ENDS),
    "gen1": (_fasta("gen1.fa"), _fasta("cdna1.fa"), *ENDS),
    "gen2": (_fasta("gen2.fa"), _fasta("cdna2.fa"), *ENDS),
    "long_introns": (*_mk_gene(np.random.default_rng(5), exon=(60, 120),
                               intron=(900, 1300)), *ENDS),
}


def _jax_run(gen, cdna, exga, exgb):
    """The JAX f32 engine: (score, skl) and its sweep's outputs."""
    bg = jab.encode(gen, jab.DNA)
    ac = jab.encode(cdna, jab.DNA)
    mtx, _ = jscoring.dna_matrix(jdefault_params(jab.DNA, "aln"))
    w = stripe(len(ac), len(bg), -50)
    got = {}
    real = SJ._sweep

    def sweep(*args):
        got["sweep"] = real(*args)
        return got["sweep"]

    SJ._sweep = sweep
    try:
        score, skl = SJ.spliced_align_device(
            ac, bg, JSpliceSignals.build(bg), JIntronPenalty.build(), mtx,
            lw=w.lw, up=w.up, exga=exga, exgb=exgb)
    finally:
        SJ._sweep = real
    carry, evs, jdons = got["sweep"]
    return score, skl, [np.asarray(x) for x in carry[:5]], \
        np.asarray(evs), np.asarray(jdons)


def _port_run(gen, cdna, exga, exgb):
    """The port on the CPU (the plain sweep): (score, skl), the sweep's
    outputs and its inputs."""
    from prrn_aln_tpu_torch import scoring
    from prrn_aln_tpu_torch.config import default_params
    bg = ab.encode(gen, ab.DNA)
    ac = ab.encode(cdna, ab.DNA)
    mtx, _ = scoring.dna_matrix(default_params(ab.DNA, "aln"))
    w = stripe(len(ac), len(bg), -50)
    got = {}
    real = SS.sweep_s

    def sweep(ins):
        got["ins"] = ins
        got["sweep"] = real(ins)
        return got["sweep"]

    SS.sweep_s = sweep
    try:
        score, skl = SS.spliced_align_device(
            ac, bg, SpliceSignals.build(bg), IntronPenalty.build(), mtx,
            lw=w.lw, up=w.up, exga=exga, exgb=exgb, device="cpu")
    finally:
        SS.sweep_s = real
    return score, skl, got["sweep"], got["ins"]


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    gen, cdna, exga, exgb = CASES[request.param]
    return {"name": request.param, "jax": _jax_run(gen, cdna, exga, exgb),
            "port": _port_run(gen, cdna, exga, exgb)}


def test_planes_equal(case):
    _, _, _, evs, jdons = case["jax"]
    sw = case["port"][2]
    np.testing.assert_array_equal(sw.ev.numpy(), evs)
    np.testing.assert_array_equal(sw.jdon.numpy(), jdons)


def test_final_band_equal(case):
    carry = case["jax"][2]
    sw = case["port"][2]
    np.testing.assert_array_equal(sw.HV.numpy(), carry[0])
    for k in range(4):
        np.testing.assert_array_equal(sw.Hi[k].numpy(), carry[k + 1])


def test_skl_and_score_equal(case):
    js, jk = case["jax"][:2]
    ps, pk = case["port"][:2]
    assert pk == jk
    # 0 f32 ulp: the scores are the same f32 value
    assert np.float32(ps) == np.float32(js)


def test_case_shapes(case):
    """The cases cover what they are named for: more waves than rows,
    the band's edges and, for long_introns, merges past the table."""
    ins = case["port"][3]
    sw = case["port"][2]
    assert sw.ev.shape == (ins.rows, ins.W)
    assert ins.waves == 2 * ins.rows + ins.W - 2
    assert (sw.ev.numpy() == -1).any()
    if case["name"] == "long_introns":
        merged = sw.jdon.numpy()
        m = np.arange(ins.m_start, ins.la + 1)[:, None, None]
        n = m + ins.lw + np.arange(ins.W)[None, :, None]
        lens = np.where(merged > 0, n - merged, 0)
        assert lens.max() > 825


def test_penalty_table_equals_jax():
    """The penalty by length equals the scan engine's compiled
    ``_penalty`` bit for bit, over the table, the tail and lengths past
    the realistic gene's 19 kb."""
    jp, pp = JIntronPenalty.build(), IntronPenalty.build()
    lb = 40000
    pack = SJ._pen_arrays(jp)
    want = np.asarray(jax.jit(lambda n: SJ._penalty(pack, n))(
        jnp.arange(lb + 2)))
    np.testing.assert_array_equal(SS.penalty_by_length(pp, lb), want)


def test_log32_equals_compiled_jnp_log():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.arange(1, 1 << 16, dtype=np.float32),
                        rng.uniform(0.5, 2.0, 1 << 16).astype(np.float32),
                        np.exp(rng.uniform(-80, 80, 1 << 16))
                        .astype(np.float32)])
    np.testing.assert_array_equal(SS._log32(x),
                                  np.asarray(jax.jit(jnp.log)(x)))


def test_fma32_rounds_once():
    """The f32 multiply-add against exact rational arithmetic (round to
    nearest, ties to even): on random values, and on two whose f64 sum
    lands on an f32 halfway point that the exact value misses by 2**-30,
    where rounding f64 to f32 would round twice and err."""
    from fractions import Fraction
    rng = np.random.default_rng(1)
    f = np.float32
    a = rng.uniform(-4, 4, 2000).astype(f)
    b = rng.uniform(-4, 4, 2000).astype(f)
    c = rng.uniform(-4, 4, 2000).astype(f)
    # (1 + 2**-15)(1 - 2**-15) = 1 - 2**-30 beside 2**24 + 2 and - 2**24 - 2
    a = np.concatenate([a, [f(1 + 2**-15)] * 2])
    b = np.concatenate([b, [f(1 - 2**-15), f(-1 + 2**-15)]])
    c = np.concatenate([c, [f(2**24 + 2), f(-2**24 - 2)]])
    got = SS._fma32(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        near = np.float32(float(exact))
        cands = [near, np.nextafter(near, f(np.inf)),
                 np.nextafter(near, f(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
        assert g == best
    assert got[-2] == f(2**24 + 2) and got[-1] == f(-2**24 - 2)
    twice = ((a[-2:].astype(np.float64) * b[-2:] + c[-2:])
             .astype(np.float32))
    assert (twice != got[-2:]).all()


def test_kernel_wrapper_takes_no_cpu_tensors():
    """``sweep_s`` takes the plain version for CPU tensors only; the
    launcher refuses them rather than fall back."""
    gen, cdna = _mk_gene(np.random.default_rng(0))
    ins = _port_run(gen, cdna, *ENDS)[3]
    with pytest.raises(ValueError, match="unsupported device"):
        SS._launch_sweep_s(ins)


@pytest.mark.parametrize("rows, ring, rpt", [
    (350, True, 1), (1024, True, 1), (1025, True, 2), (2201, False, 3)])
def test_sweep_plan(rows, ring, rpt):
    """The global variant's plan: rows spread over at most 1,024 threads,
    the rings in shared memory while they fit."""
    plan = SS.sweep_s_plan(rows, 17, 19002, variant="global")
    assert plan["variant"] == "global" and plan["ctas"] == 1
    assert plan["rpt"] == rpt and plan["ring_smem"] == ring
    assert plan["threads"] * plan["rpt"] >= rows
    assert plan["threads"] <= SS.K5_THREADS and plan["threads"] % 32 == 0
    assert plan["smem"] <= SS.K5_SMEM_MAX


# the cluster variant's shared bytes a CTA without the penalty table: the
# matrix and pair53, a boundary ring a warp, the position ring
def _cluster_base(rows_cta, K=17):
    return 4 * (K * K + 256 + rows_cta // 32 * SS.K5_RING_DEPTH
                * SS.K5_BOUNDARY_WORDS + SS.K5_POS_WORDS)


# (rows, npen, keywords) -> (variant, CTAs, rows a CTA, penalty table in
# shared memory): each limit and one past it
CLUSTER_PLANS = [
    (1, 19002, {}, ("cluster", 1, 32, True)),
    (313, 1030, {}, ("cluster", 10, 32, True)),
    (2275, 18452, {}, ("cluster", 15, 160, True)),
    (256, 19002, dict(ctas=1), ("cluster", 1, 256, True)),
    (255, 19002, dict(ctas=1), ("cluster", 1, 256, True)),
    (257, 19002, dict(ctas=2), ("cluster", 2, 160, True)),
    (512, 19002, {}, ("cluster", 16, 32, True)),
    (513, 19002, {}, ("cluster", 9, 64, True)),
    (4096, 19002, {}, ("cluster", 16, 256, True)),
    (4097, 19002, {}, ("chained", 13, 64, True)),
    (3840, 19002, dict(cluster_max=15), ("cluster", 15, 256, True)),
    (3841, 19002, dict(cluster_max=15), ("chained", 13, 64, True)),
    (4096, (SS.K5_SMEM_MAX - _cluster_base(256)) // 4, {},
     ("cluster", 16, 256, True)),
    (4096, (SS.K5_SMEM_MAX - _cluster_base(256)) // 4 + 1, {},
     ("cluster", 16, 256, False)),
    (300, 19002, dict(pen_smem=False), ("cluster", 10, 32, False)),
]


@pytest.mark.parametrize("rows, npen, kw, want", CLUSTER_PLANS)
def test_sweep_plan_cluster(rows, npen, kw, want):
    """One row a thread in whole warps over at most 16 CTAs (the
    non-portable cluster) up to 4,096 rows, every row covered, the slab
    the smallest the cluster holds; the penalty table in shared memory
    while it fits; past that the chained variant (CTAs a cluster)."""
    plan = SS.sweep_s_plan(rows, 17, npen, **kw)
    assert (plan["variant"], plan["ctas"], plan["rows"],
            plan["pen_smem"]) == want
    assert plan["smem"] <= SS.K5_SMEM_MAX
    if plan["variant"] == "cluster":
        assert plan["rows"] % 32 == 0 and plan["rpt"] == 1
        assert plan["ctas"] * plan["rows"] >= rows
        assert (plan["ctas"] - 1) * plan["rows"] < rows
        assert plan["smem"] == _cluster_base(plan["rows"]) + (
            4 * npen if plan["pen_smem"] else 0)


@pytest.mark.parametrize("rows, npen, K, kw", [
    (257, 19002, 17, dict(variant="cluster", ctas=1)),
    (100, 19002, 17, dict(variant="cluster", ctas=17)),
    (100, 19002, 17, dict(variant="cluster", ctas=0)),
    (4097, 19002, 17, dict(variant="cluster")),
    (100, 19002, 257, dict(variant="cluster")),
    (100, 60000, 17, dict(variant="cluster", pen_smem=True)),
    (100, 19002, 17, dict(variant="global", ctas=2)),
    (100, 19002, 17, dict(variant="shared")),
    (100, 60000, 17, dict(variant="global", pen_smem=True)),
    (4097, 19002, 257, dict(variant="chained")),
    (6000, 19002, 17, dict(variant="chained", ctas=17)),
    (6000, 19002, 17, dict(variant="chained", ctas=0)),
    (4096, 19002, 17, dict(variant="chained", clusters=1)),
    (20000, 19002, 17, dict(variant="chained", clusters=4)),
    (20000, 19002, 17, dict(variant="chained", clusters=0)),
    (20, 19002, 17, dict(variant="chained", clusters=2)),
    (6000, 19002, 17, dict(variant="chained", per_pass=0)),
    (6000, 19002, 17, dict(held=0)),
    (100, 19002, 17, dict(variant="cluster", ctas=1, clusters=4)),
    (100, 19002, 17, dict(variant="global", clusters=2)),
    (6000, 60000, 17, dict(variant="chained", pen_smem=True))])
def test_sweep_plan_refuses_what_the_kernels_cannot_take(rows, npen, K, kw):
    """More than 256 rows a CTA or 16 CTAs, a matrix past 256 codes in
    the cluster or chained variant, more than one block of the global
    variant, one cluster asked of the chained variant (or rows that fill
    only one) or several of the cluster variant, no cluster a launch, an unknown
    variant, more than 227 KB of shared memory: the plan raises, and
    nothing falls back to another plan."""
    with pytest.raises(ValueError):
        SS.sweep_s_plan(rows, K, npen, **kw)


# (rows, keywords) -> (clusters, CTAs a cluster, rows a CTA, clusters a
# launch, launches): the chained variant's default plan past 4,096 rows
# (64 rows a CTA while the card holds the clusters at once), under a cap
# of clusters the card holds at once, and on a cluster cut to 15 CTAs
CHAINED_PLANS = [
    (4097, {}, (5, 13, 64, 5, 1)),
    (6000, {}, (6, 16, 64, 6, 1)),
    (20000, {}, (20, 16, 64, 20, 1)),
    (20000, dict(held=7), (7, 15, 192, 7, 1)),
    (20000, dict(held=2), (5, 16, 256, 2, 3)),
    (6000, dict(held=1), (2, 16, 192, 1, 2)),
    (6000, dict(cluster_max=15), (7, 14, 64, 7, 1)),
    (65536, dict(held=7), (16, 16, 256, 7, 3)),
]


@pytest.mark.parametrize("rows, kw, want", CHAINED_PLANS)
def test_sweep_plan_chained(rows, kw, want):
    """Past what one cluster holds the plan chains clusters of the
    cluster variant's shape (K = 5, the DNA matrix): enough for 64 rows a
    CTA, no more than the card holds at once unless fewer cannot hold
    the rows, the rows spread evenly over their CTAs in whole warps,
    every cluster with rows, at most ``held`` clusters a launch, the
    stage ring of the column one more ring a CTA."""
    npen = 26000
    plan = SS.sweep_s_plan(rows, 5, npen, **kw)
    assert plan["variant"] == "chained"
    assert (plan["clusters"], plan["ctas"], plan["rows"], plan["per_pass"],
            plan["passes"]) == want
    per = plan["ctas"] * plan["rows"]
    assert plan["rows"] % 32 == 0 and plan["rows"] <= SS.K5_ROWS_MAX
    assert plan["threads"] == plan["rows"] and plan["rpt"] == 1
    assert plan["clusters"] * per >= rows > (plan["clusters"] - 1) * per
    assert plan["per_pass"] <= kw.get("held", plan["clusters"])
    assert plan["passes"] == -(-plan["clusters"] // plan["per_pass"])
    assert plan["pen_smem"]
    assert plan["smem"] == _cluster_base(plan["rows"], K=5) + 4 * (
        SS.K5_RING_DEPTH * SS.K5_BOUNDARY_WORDS + npen)
    assert plan["smem"] <= SS.K5_SMEM_MAX


@pytest.mark.parametrize("rows", [1, 31, 4095, 4096, 4097, 5000, 8192,
                                  8193, 12345, 40000, 100000])
@pytest.mark.parametrize("K", [5, 17, 64])
def test_sweep_plan_never_global_by_default(rows, K):
    """No default plan picks the global variant for a matrix of at most
    256 codes whose shared bytes fit: one cluster up to 4,096 rows,
    chained clusters past it."""
    plan = SS.sweep_s_plan(rows, K, 19002)
    assert plan["variant"] == ("cluster" if rows <= 4096 else "chained")
    assert plan["clusters"] * plan["ctas"] * plan["rows"] >= rows


@pytest.mark.parametrize("rows, held, want", [
    (3000, {16: 0, 14: 0}, ("cluster", 1, 12, 1)),
    (6000, {16: 1}, ("chained", 2, 16, 1)),
    (20000, {16: 3}, ("chained", 5, 16, 3)),
    (6000, {16: 0, 15: 0, 14: 2}, ("chained", 2, 14, 2))])
def test_launch_plan_within_what_the_card_holds(monkeypatch, rows, held,
                                                 want):
    """``launch_plan`` cuts the cluster until the card holds one of it
    (cudaOccupancyMaxActiveClusters, stubbed here by CTAs a cluster), so
    the chained variant takes the rows a smaller cluster cannot, and runs
    no more clusters a launch than the card holds at once."""
    monkeypatch.setattr(SS, "clusters_held",
                        lambda plan: held.get(plan["ctas"], 7))
    plan = SS.launch_plan(rows, 5, 26000)
    assert (plan["variant"], plan["clusters"], plan["ctas"],
            plan["per_pass"]) == want
    assert held.get(plan["ctas"], 7) >= plan["per_pass"]
