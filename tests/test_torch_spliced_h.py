"""The port's fwd2h (spliced protein x genome DP) against the JAX package
on the CPU: the tables it is built from (the intron penalty by length
among them, to 40,001 nt), the plain sweep's planes against the JAX scan
engine's (on mini and on a seeded gene whose introns reach the penalty's
log tail), and forwardH's score and knots on four cases cut from the
in-repo CET10B9 window and ce13a1."""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prrn_aln_tpu import alphabet as jab, io as jio, scoring as jscoring
from prrn_aln_tpu.config import default_params as jdefault_params
from prrn_aln_tpu.ops import spliced_h_jax as jsh, spliced_jax as jsj
from prrn_aln_tpu.ops.spliced_h_np import HParams as JHParams
from prrn_aln_tpu.splice import hapi as jhapi, tron as jtron
from prrn_aln_tpu.splice.exin import build_exin as jbuild_exin
from prrn_aln_tpu.splice.penalty import IntronPenalty as JIntronPenalty
from prrn_aln_tpu_torch import alphabet as ab, io as pio, scoring
from prrn_aln_tpu_torch.config import default_params
from prrn_aln_tpu_torch.ops import spliced_h as sh
from prrn_aln_tpu_torch.ops.spliced_h_np import HParams
from prrn_aln_tpu_torch.splice import hapi, tron
from prrn_aln_tpu_torch.splice.exin import build_exin
from prrn_aln_tpu_torch.splice.penalty import IntronPenalty

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import LONG_INTRONS, long_intron_gene  # noqa: E402

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"
# the penalty of test_spliced_h_jax.py's cases
PEN = dict(f=1.0, y=8.0, sss=0.5, u=2.0, v=9.0, ip=15.0, fact=8.0)


@functools.lru_cache(maxsize=None)
def _window() -> str:
    return jio.sniff_and_read(FIX / "cet10b9_win31401.fa")[0].seq.upper()


@functools.lru_cache(maxsize=None)
def _ce13a1() -> str:
    return jio.sniff_and_read(FIX / "ce13a1_unaligned.fa")[0].seq


# test_spliced_h_jax.py's four cases, rebuilt from the window
# (CET10B9[31401:33700], so CET10B9[31549:...] = window[149:...]):
# genome, protein, band shoulder %, intron-position bonus
CASES = {
    "mini": (slice(149, 1050), 172, 50, None),
    "two_introns": (slice(149, 1700), 290, 50, None),
    "intron_bonus": (slice(149, 1050), 172, 50, 3 * 62),
    "no_intron": (slice(214, 400), 60, 100, None),
}
def _pmtx(scoring_mod, ab_mod, dp):
    pm, _ = scoring_mod.build_matrix(ab_mod.PROTEIN, dp(ab_mod.PROTEIN, "aln"))
    return pm


def _qprof(tron_mod, pm, a):
    tm = tron_mod.tron_matrix(pm, u=2.0, o=30.0)
    M = len(a)
    qprof = np.zeros((M + 2, tron_mod.TSIMD))
    for m in range(1, M + 1):
        qprof[m] = tm[a[m - 1]]
    qprof[M + 1] = qprof[M]
    return qprof


@functools.lru_cache(maxsize=None)
def _run_case(name):
    """Both packages' forwardH on one case; the sweep planes of each are
    captured by wrappers around their sweep functions."""
    if name == "long_introns":
        (g, p), sh_pct, bonus = long_intron_gene(), 50, None
    else:
        gsl, plen, sh_pct, bonus = CASES[name]
        g, p = _window()[gsl], _ce13a1()[:plen]

    def api(pt):
        return 20.0 if pt == bonus else 0.0

    jb, ja = jab.encode(g, jab.DNA), jab.encode(p, jab.PROTEIN)
    M, N = len(ja), len(jb)
    shld = 3 * (sh_pct * min(M, N) // 100)
    lw, up = -shld, min(N - 3 * M + shld, N)
    got = {}

    real_j = jsh._sweep_h

    def rec_j(*args):
        out = real_j(*args)
        got["jax_planes"] = [np.asarray(x) for x in out]
        return out

    jsh._sweep_h = rec_j
    try:
        got["jax"] = jsh.forward_h_device(
            _qprof(jtron, _pmtx(jscoring, jab, jdefault_params), ja), jb,
            jbuild_exin(jb), JIntronPenalty.build(**PEN), JHParams(), lw,
            up, api=api if bonus else None)
    finally:
        jsh._sweep_h = real_j

    real_p = sh.sweep_h

    def rec_p(ins):
        out = real_p(ins)
        got["port_planes"] = out
        return out

    real_w = sh.walk_h

    def rec_w(*args):
        out = real_w(*args)
        got["walk"] = (args, out)
        return out

    b, a = ab.encode(g, ab.DNA), ab.encode(p, ab.PROTEIN)
    sh.sweep_h, sh.walk_h = rec_p, rec_w
    try:
        got["port"] = sh.forward_h_device(
            _qprof(tron, _pmtx(scoring, ab, default_params), a), b,
            build_exin(b), IntronPenalty.build(**PEN), HParams(), lw, up,
            api=api if bonus else None, device="cpu")
    finally:
        sh.sweep_h, sh.walk_h = real_p, real_w
    got["band"] = (lw, up)
    return got


# ---------------------------------------------------------------------
# (i) the tables: no learned weights, only arrays built from .npz data

def test_tron_matrix_equal():
    jt = jtron.tron_matrix(_pmtx(jscoring, jab, jdefault_params), u=2.0,
                           o=30.0)
    pt = tron.tron_matrix(_pmtx(scoring, ab, default_params), u=2.0, o=30.0)
    np.testing.assert_array_equal(pt, jt)


@pytest.mark.parametrize("genome", ["mini_gen.fa", "cet10b9_win31401.fa"])
def test_exin_signals_equal(genome):
    seq = jio.sniff_and_read(FIX / genome)[0].seq.upper()
    je = jbuild_exin(jab.encode(seq, jab.DNA))
    pe = build_exin(ab.encode(seq, ab.DNA))
    for f in dataclasses.fields(je):
        jv, pv = getattr(je, f.name), getattr(pe, f.name)
        if f.name == "sig":
            for g in dataclasses.fields(jv):
                np.testing.assert_array_equal(getattr(pv, g.name),
                                              getattr(jv, g.name))
        else:
            np.testing.assert_array_equal(pv, jv)


def test_intron_penalty_equal():
    jp, pp = JIntronPenalty.build(**PEN), IntronPenalty.build(**PEN)
    np.testing.assert_array_equal(pp.table, jp.table)
    assert pp.closed == jp.closed
    for f in ("llmt", "rlmt", "mu", "int_ep", "int_fx", "gap_wi", "minl",
              "mode"):
        assert getattr(pp, f) == getattr(jp, f)


def test_codon_tables_equal():
    seq = _window()
    for jx, px in zip(jsh._codon_tables(jab.encode(seq, jab.DNA)),
                      sh._codon_tables(ab.encode(seq, ab.DNA))):
        np.testing.assert_array_equal(px, jx)


@pytest.mark.parametrize("query", ["single", "msa"])
def test_query_profile_equal(query):
    jt = jtron.tron_matrix(_pmtx(jscoring, jab, jdefault_params), u=2.0,
                           o=30.0)
    pt = tron.tron_matrix(_pmtx(scoring, ab, default_params), u=2.0, o=30.0)
    if query == "single":
        p = _ce13a1()
        jq = jhapi.build_qprof(jab.encode(p, jab.PROTEIN), jt)
        pq = hapi.build_qprof(ab.encode(p, ab.PROTEIN), pt)
    else:
        jm = jio.records_to_msa(jio.sniff_and_read(FIX / "ce13a.msa"),
                                jab.PROTEIN)
        pm = pio.records_to_msa(pio.sniff_and_read(FIX / "ce13a.msa"),
                                ab.PROTEIN)
        jq = jhapi.profile_qprof(jm.codes, jm.weight, jt)
        pq = hapi.profile_qprof(pm.codes, pm.weight, pt)
    np.testing.assert_array_equal(pq, jq)


# ---------------------------------------------------------------------
# (ii) the plain sweep against the JAX scan engine

def _planes_match(name):
    """Event and junction planes and the final band's directions equal;
    band values to rtol 1e-5 (XLA may fuse a product into a multiply-add
    where the plain version rounds twice)."""
    got = _run_case(name)
    bandV, bandD, evw, jdw = got["jax_planes"]
    sw = got["port_planes"]
    np.testing.assert_array_equal(sw.ev.numpy(), evw.astype(np.int32))
    np.testing.assert_array_equal(sw.jd.numpy().transpose(0, 2, 1), jdw)
    np.testing.assert_array_equal(sw.bandD.numpy(), bandD)
    np.testing.assert_allclose(sw.bandV.numpy(), bandV, rtol=1e-5)
    return got


def test_sweep_planes_match_jax_scan_engine():
    _planes_match("mini")


def test_sweep_planes_match_jax_past_the_log_tail():
    """A gene whose introns (879 and 1,187 nt) lie where a correctly
    rounded log and the scan engine's compiled one differ: the planes
    still equal the JAX engine's, and junctions of those lengths were
    merged (the knots span both introns)."""
    got = _planes_match("long_introns")
    knots = got["jax"][1]
    assert knots == got["port"][1]
    spans = {n1 - n0 for (m0, n0), (m1, n1) in zip(knots[:-1], knots[1:])
             if m0 == m1}
    assert set(LONG_INTRONS) <= spans


@pytest.mark.parametrize("pen", ["default", "fwd2h_cases"])
def test_penalty_by_length_equals_jax(pen):
    """The table by length fwd2h packs (``pext``) and its gather for a
    negative length equal the scan engine's compiled ``_penalty`` bit for
    bit over lengths -5 ... 40,001: the f32 table, NEVSEL below llmt,
    gap_wi below 0 and the log tail."""
    kw = PEN if pen == "fwd2h_cases" else {}
    jp, pp = JIntronPenalty.build(**kw), IntronPenalty.build(**kw)
    N = 40000
    lens = np.arange(-5, N + 2)
    pack = jsj._pen_arrays(jp)
    want = np.asarray(jax.jit(lambda n: jsj._penalty(pack, n))(
        jnp.asarray(lens)))
    pext = torch.as_tensor(sh.penalty_by_length(pp, N))
    got = sh._penalty(pext, torch.tensor(np.float32(pp.gap_wi)),
                      torch.as_tensor(lens))
    np.testing.assert_array_equal(got.numpy(), want)
    assert pext.shape == (N + 2,)


# ---------------------------------------------------------------------
# (iii) forwardH: the port's plain path against the JAX device engine

@pytest.mark.parametrize("case", list(CASES))
def test_forward_h_matches_jax(case):
    """Score within 1e-3 relative and knots equal: the tolerance of
    tests/test_spliced_h_jax.py."""
    got = _run_case(case)
    (s_j, k_j), (s_p, k_p) = got["jax"], got["port"]
    assert abs(s_p - s_j) <= 1e-3 * max(1.0, abs(s_j))
    assert k_p == k_j


@pytest.mark.parametrize("case", list(CASES))
def test_walk_matches_jax_host_walker(case):
    """The plain walk (a transcription of the device walk) against the
    JAX package's host walker on the JAX planes, from the same end cell:
    the same knots before the init record's."""
    got = _run_case(case)
    (ev, jd, t_min, M, N, om, on), wk = got["walk"]
    _, _, evw, jdw = got["jax_planes"]
    lw, up = got["band"]
    jknots = jsh._walk_h(evw, jdw, t_min, om, on, M, N, lw, up,
                         np.zeros(up - lw + 7, np.int8), {}, True, True,
                         lambda r: r - lw + 3)
    assert wk.knots == jknots[:-1]
    assert 0 < wk.steps < sh.walk_steps(M, N)


# ---------------------------------------------------------------------
# (iv) K4's launch plan (csrc/spliced_h_wave.cu reads it; pure Python)

# M + 1 -> variant, CTAs, rows a CTA, rows a thread, shared bytes a CTA,
# with the default 806-entry penalty table: 4 * (162 * rows + 26 + 6,144
# + 806 + 256) for the cluster variant, 4 * (806 + 256) for the global
# one
PLANS = {
    1: ("cluster", 1, 32, 1, 49664),
    173: ("cluster", 6, 32, 1, 49664),
    512: ("cluster", 8, 64, 1, 70400),
    513: ("cluster", 6, 96, 1, 91136),
    527: ("cluster", 6, 96, 1, 91136),
    1100: ("cluster", 7, 160, 1, 132608),
    2048: ("cluster", 8, 256, 1, 194816),
    2049: ("global", 1, 416, 5, 4248),
    4000: ("global", 1, 512, 8, 4248),
}


@pytest.mark.parametrize("MR", list(PLANS))
def test_sweep_plan(MR):
    """One row a thread in whole warps over at most 8 CTAs up to 2,048
    rows, every row covered, the slab the smallest 8 CTAs hold; past
    that the global variant, rows spread over at most 512 threads."""
    plan = sh.sweep_plan(MR, 806)
    assert (plan["variant"], plan["ctas"], plan["rows"], plan["rpt"],
            plan["smem"]) == PLANS[MR]
    assert plan["ctas"] * plan["rows"] * plan["rpt"] >= MR
    if plan["variant"] == "cluster":
        assert plan["rows"] % 32 == 0
        assert (plan["ctas"] - 1) * plan["rows"] < MR
        assert plan["rows"] == sh.sweep_plan(MR, 806, ctas=8)["rows"]


@pytest.mark.parametrize("MR, ctas, rows", [(121, 1, 128), (527, 3, 192),
                                            (527, 4, 160), (1100, 5, 224)])
def test_sweep_plan_cluster_size_asked(MR, ctas, rows):
    plan = sh.sweep_plan(MR, 806, variant="cluster", ctas=ctas)
    assert (plan["variant"], plan["ctas"], plan["rows"]) == \
        ("cluster", ctas, rows)
    assert plan["smem"] == 4 * (sh.K4_ROW_WORDS * rows + 26 + 6144 + 806
                                + 256)


@pytest.mark.parametrize("kw", [dict(MR=527, variant="cluster", ctas=2),
                                dict(MR=100, variant="cluster", ctas=9),
                                dict(MR=100, variant="global", ctas=2),
                                dict(MR=100, variant="shared"),
                                dict(MR=4000, npen=60000)])
def test_sweep_plan_refuses_what_the_kernel_cannot_take(kw):
    """More than 256 rows a CTA or 8 CTAs, more than one block of the
    global variant, an unknown variant, more than 227 KB of shared
    memory: the plan raises, and nothing falls back to another plan."""
    kw = dict(kw)
    MR, npen = kw.pop("MR"), kw.pop("npen", 806)
    with pytest.raises(ValueError):
        sh.sweep_plan(MR, npen, **kw)


# ---------------------------------------------------------------------
# (v) K4w's launch plan (csrc/spliced_h_walk.cu reads it; pure Python)

# depth -> rows a slot, words a slot, shared bytes: 16 + 8 D + 4 D S
WALK_PLANS = {
    8: (5, 8, 336),
    16: (8, 12, 912),
    64: (24, 28, 7696),
    128: (45, 48, 25616),
    256: (88, 92, 96272),
}


@pytest.mark.parametrize("depth", list(WALK_PLANS))
def test_walk_plan(depth):
    """A ring of D waves, each slot R = ceil(D / 3) + 2 rows of ev (the
    rows the next D waves below the walker can reach) rounded out to 16
    bytes, staged by four warps beside the walker; D = 128 by default."""
    plan = sh.walk_plan(3875, 527, depth=depth)
    assert (plan["rows"], plan["slot_words"], plan["smem_bytes"]) == \
        WALK_PLANS[depth]
    assert plan["rows"] >= -(-depth // 3) + 2
    assert plan["slot_words"] % 4 == 0
    assert plan["slot_words"] >= plan["rows"] + 3
    assert plan["threads"] == 32 * (1 + sh.K4W_STAGERS)
    assert plan["depth"] % sh.K4W_STAGERS == 0
    assert sh.walk_plan(3875, 527)["depth"] == sh.K4W_DEPTH == 128


@pytest.mark.parametrize("T, MR, kw", [
    (3875, 527, {"depth": 4}),        # below the smallest ring
    (3875, 527, {"depth": 7}),        # not a power of two
    (3875, 527, {"depth": 96}),
    (3875, 527, {"depth": 512}),      # 360 KB of shared memory
    (0, 527, {}),
    (3875, 0, {}),
    (2 ** 22, 2 ** 9, {}),            # 2**31 words of ev
])
def test_walk_plan_refuses_what_the_kernel_cannot_take(T, MR, kw):
    with pytest.raises(ValueError):
        sh.walk_plan(T, MR, **kw)
    assert sh.walk_plan(2 ** 22 - 1, 2 ** 9)["depth"] == 128
