"""The port's tracer (``prrn_aln_tpu_torch/utils/trace.py``) on the CPU:
off, a span is the shared no-op and records nothing; on, spans nest by
parent and share their request; the launch counter is the tracer's,
and its launch view leaves the other counts out;
K3's move count is the walked path; and ``prrn`` traced yields the
refinement's spans and counts and writes the same bytes as untraced."""

import collections
from pathlib import Path

import numpy as np
import pytest
import torch

from prrn_aln_tpu_torch import alphabet as ab, io, scoring
from prrn_aln_tpu_torch.cli import prrn_main
from prrn_aln_tpu_torch.config import AlnParams
from prrn_aln_tpu_torch.msa.msa import Msa
from prrn_aln_tpu_torch.ops import _build, group as tg
from prrn_aln_tpu_torch.ops.path_score import skl_to_moves
from prrn_aln_tpu_torch.utils import trace

# one intra-op thread: the suite runs several worker processes at once
torch.set_num_threads(1)

FIX = Path(__file__).parent / "fixtures"
MTX, _ = scoring.protein_matrix(AlnParams(pam=150))
REFINE_SPANS = ("prrn.refine", "prrn.refine.tree", "prrn.refine.prepare",
                "prrn.score_path", "prrn.refine.apply", "prrn.group.pack",
                "prrn.group.k2", "prrn.group.k3", "prrn.group.fetch")


@pytest.fixture
def tracing():
    trace.take()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.take()


def test_span_off_is_the_shared_noop_and_records_nothing():
    trace.disable()
    trace.take()
    assert trace.span("a") is trace.span("b") is trace.request("c")
    with trace.request("prrn.main"):
        with trace.span("prrn.refine"):
            pass
    assert trace.take() == []


def test_launches_are_the_tracers_counts():
    assert _build.LAUNCHES is trace.COUNTS


def test_spans_nest_by_parent_and_share_their_request(tracing):
    with trace.span("outside"):
        pass
    for _ in range(2):
        with trace.request("root"):
            with trace.span("a"):
                with trace.span("b"):
                    pass
            with trace.span("c"):
                pass
    recs = trace.take()
    assert [r.name for r in recs] == ["outside"] + ["root", "a", "b", "c"] * 2
    assert [r.parent for r in recs] == [-1, -1, 1, 2, 1, -1, 5, 6, 5]
    assert recs[0].request == 0
    first, second = recs[1].request, recs[5].request
    assert first > 0 and second == first + 1
    assert [r.request for r in recs[1:]] == [first] * 4 + [second] * 4
    for r in recs:
        assert 0 < r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert trace.take() == []


def _group(rng, many, length):
    codes = (rng.integers(0, 20, size=(many, length)) + ab.ALA).astype(
        np.int8)
    codes[rng.random((many, length)) < 0.08] = ab.GAP
    codes[:, 0] = ab.ALA
    m = Msa(codes=codes, molc=ab.PROTEIN,
            names=[f"s{i}" for i in range(many)])
    m.prepare(MTX.shape[0])
    return m


@pytest.mark.parametrize("align", ["group_align", "group_align_linear"])
def test_k3_moves_count_the_walked_path(align):
    """K3's move count is the path's length, whichever walk made it, and
    the copies to and from the device are counted."""
    rng = np.random.default_rng(3)
    A, B = _group(rng, 3, 37), _group(rng, 3, 44)
    before = collections.Counter(trace.COUNTS)
    _, skl = getattr(tg, align)(A, B, MTX, u=2.0, v=9.0, device="cpu")
    got = trace.COUNTS - before
    assert got["k3.moves"] == len(skl_to_moves(skl)) > 0
    assert got["copy.h2d_bytes"] > 0 and got["copy.d2h_bytes"] > 0


@pytest.fixture(scope="module")
def traced_prrn(tmp_path_factory):
    """``prrn -R 0`` on five members of ce13a17 (their first 60 residues),
    untraced then traced: the outputs, the counts and the records."""
    tmp = tmp_path_factory.mktemp("trace")
    recs = io.sniff_and_read(FIX / "ce13a17_clean.fa")[:5]
    fasta = tmp / "five.fa"
    fasta.write_text("".join(f">{r.name}\n{r.seq.replace('-', '')[:60]}\n"
                             for r in recs))
    out = {}
    counts = {}
    records = []
    for on in (False, True):
        trace.take()
        if on:
            trace.enable()
        before = collections.Counter(trace.COUNTS)
        try:
            assert prrn_main(["-R", "0", "--device", "cpu", "-o",
                              str(tmp / f"{on}.txt"), str(fasta)]) == 0
        finally:
            trace.disable()
        counts[on] = trace.COUNTS - before
        out[on] = (tmp / f"{on}.txt").read_bytes()
        records = trace.take()
    return out, counts, records


def test_traced_prrn_yields_every_refine_span(traced_prrn):
    _, _, recs = traced_prrn
    names = {r.name for r in recs}
    assert set(REFINE_SPANS) <= names
    assert {"prrn.main", "prrn.distance", "prrn.progressive",
            "prrn.write"} <= names


def test_traced_prrn_spans_nest_under_one_request(traced_prrn):
    _, _, recs = traced_prrn
    roots = [r for r in recs if r.parent == -1]
    assert [r.name for r in roots] == ["prrn.main"]
    assert len({r.request for r in recs}) == 1 and recs[0].request > 0

    def ancestors(r):
        while r.parent >= 0:
            r = recs[r.parent]
            yield r.name
    for r in recs:
        if r.name == "prrn.score_path":
            assert next(ancestors(r)) == "prrn.refine.prepare"
        if r.name.startswith("prrn.refine."):
            assert "prrn.refine" in set(ancestors(r))


def test_traced_prrn_counts_its_candidates(traced_prrn):
    _, counts, recs = traced_prrn
    # the counters do not depend on the spans
    assert counts[True] == counts[False]
    c = counts[True]
    by_name = collections.Counter(r.name for r in recs)
    assert c["refine.attempted"] >= c["refine.accepted"] >= 1
    assert by_name["prrn.refine.apply"] == c["refine.accepted"]
    # one preparation a drawn partition: realigned or skipped
    assert by_name["prrn.refine.prepare"] == (c["refine.attempted"]
                                              + c["refine.skipped"])
    assert by_name["prrn.group.k2"] == by_name["prrn.group.k3"]
    assert c["copy.h2d_bytes"] > 0 and c["copy.d2h_bytes"] > 0


def test_tracing_leaves_the_output_unchanged(traced_prrn):
    out, _, _ = traced_prrn
    assert out[True] == out[False] and out[True]


def test_launch_view_leaves_out_every_other_count(traced_prrn, monkeypatch):
    """A sum over ``launches()`` counts launches alone: every count a run
    makes besides them carries a dotted name."""
    _, counts, _ = traced_prrn
    assert counts[True] and all("." in k for k in counts[True])
    monkeypatch.setattr(trace, "COUNTS", counts[True] + collections.Counter(
        {"pairwise": 1, "group_wavefront": 3}))
    assert trace.launches() == {"pairwise": 1, "group_wavefront": 3}
