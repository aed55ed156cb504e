"""High-level spliced-alignment API: aln -G equivalent.

Aligns a transcript (cDNA/EST) against a genomic DNA sequence,
recovering the exon/intron structure, and renders any of the
reference's gene-structure output formats.

Counterpart of ``prrn_aln_tpu/splice/api.py``.  The JAX package picks
its engine by backend: the float64 oracle on a CPU, the f32 scan engine
on an accelerator.  The port always runs the f32 engine
(``ops/spliced_s.spliced_align_device``): kernel K5 on a CUDA device and
its plain version on ``device="cpu"``.  So where an f32 score tie falls
the other way than in f64 (gen2 x cdna2 in ``tests/fixtures``), the
port's CPU output equals the JAX f32 engine's, not the JAX CLI's on a
CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import alphabet as ab
from .. import scoring
from ..config import default_params
from ..ops.spliced_s import spliced_align_device
from ..ops.window import stripe
from .gsinfo import GeneStructure, gene_structure
from .penalty import IntronPenalty
from .signals import SpliceSignals
from . import output as fmt

ALN_DEF_SH = -50          # aln setdefparam (aln.cc:573)


@dataclasses.dataclass
class SplicedResult:
    score: float          # DP score
    skl: list             # path knots (transcript, genome)
    gs: GeneStructure
    gname: str
    qname: str
    genome: str
    cdna: str
    u: float
    v: float

    @property
    def reported_score(self) -> float:
        return self.gs.reported_score(v=self.v, u=self.u,
                                      dp_score=self.score)

    @property
    def exons(self):
        """1-based inclusive genome coordinates per exon."""
        return [(e.left + 1, e.right) for e in self.gs.exons]

    def render(self, mode: int = 1) -> str:
        """Render in the reference -O output mode (OutFm enum)."""
        rep = self.reported_score
        glen = len(self.genome)
        qlen = len(self.cdna)
        if mode in (0, 8):        # GFF_FORM (8 aliases via nsa & 7)
            return fmt.gff3_gene(self.gs, self.gname, glen, self.qname,
                                 rep)
        if mode == 2:             # PWA_FORM
            return fmt.gff3_match(self.gs, self.skl, self.gname, glen,
                                  self.qname)
        if mode == 3:             # BED_FORM
            return fmt.bed_line(self.gs, self.gname, self.qname, rep)
        if mode == 4:             # EXN_FORM
            return fmt.exon_table(self.gs, self.genome, self.gname,
                                  self.qname, qlen, rep)
        if mode == 5:             # ITN_FORM
            return fmt.intron_table(self.gs, self.genome, self.gname,
                                    self.qname, qlen)
        if mode == 16:            # CIGAR (extension)
            return fmt.cigar_line(self.gs, self.gname, self.qname,
                                  self.skl)
        if mode == 17:            # VULGAR (extension)
            return fmt.vulgar_line(self.gs, self.gname, self.qname,
                                   self.skl)
        if mode == 18:            # SAM (extension)
            return fmt.sam_line(self.gs, self.gname, self.qname,
                                self.skl, self.cdna, qlen)
        return fmt.spliced_alignment_text(
            self.gs, self.skl, self.genome, self.cdna, self.gname,
            self.qname, rep, u=self.u, v=self.v)


def spliced_align(genome: str, cdna: str, gname: str = "genome",
                  qname: str = "query", sh: int = ALN_DEF_SH,
                  u: float | None = None, v: float | None = None,
                  species: str | None = None, *,
                  device) -> SplicedResult:
    """Align cDNA to genomic DNA with intron modelling (aln -G).
    device: torch device of the forward sweep."""
    genome = genome.upper()
    cdna = cdna.upper()
    prm = default_params(ab.DNA, "aln")
    if u is None:
        u = prm.u
    if v is None:
        v = prm.v
    mtx, _ = scoring.dna_matrix(dataclasses.replace(prm, u=u, v=v))
    bg = ab.encode(genome, ab.DNA)
    ac = ab.encode(cdna, ab.DNA)
    tabs, ipkw = None, {}
    if species:
        from .species import load_species, ipen_kwargs
        sp = load_species(species)
        tabs = sp["tabs"] or None
        ipkw = ipen_kwargs(sp)
    sig = SpliceSignals.build(bg, tabs=tabs)
    ipen = IntronPenalty.build(u=u, v=v, **ipkw)
    w = stripe(len(ac), len(bg), sh)
    score, skl = spliced_align_device(ac, bg, sig, ipen, mtx, u=u, v=v,
                                      lw=w.lw, up=w.up, device=device)
    gs = gene_structure(ac, bg, skl, sig, ipen, mtx, u=u, v=v)
    return SplicedResult(score=score, skl=skl, gs=gs, gname=gname,
                         qname=qname, genome=genome, cdna=cdna, u=u, v=v)
