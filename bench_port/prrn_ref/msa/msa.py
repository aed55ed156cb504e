"""MSA / profile container.

Host-side representation of a (multiple) sequence alignment plus the
derived per-column arrays the group DP kernel consumes:

* ``codes``  (many, len) int8 residue codes (0=nil, 1=gap, 2.. residues)
* ``weight`` (many,) tree-derived sequence weights (reference mSeq::weight)
* frequency matrix (len, dim) of weighted residue counts — the VECTOR
  level of the reference profile (mseq.cc:504-587 convseq); the profile
  (VECPRO) is freq @ mtx, computed on device
* thickness cfq/dfq/efq with boundary entries (mseq.cc:149-340 mkthick)
* gap densities / post-gap densities per member-column with terminal-gap
  discounting (mseq.h:148-158 gapdensity/postgapdensity)

End-gap handling mirrors exg_seq (seq.cc:858-887): with free end gaps or a
terminal-gap factor < 1, terminal gap runs become nil (scoring 0 against
everything) and their densities are discounted by 0 / tgapf.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import alphabet as ab

NIL, GAP = ab.NIL, ab.GAP


@dataclasses.dataclass
class Msa:
    codes: np.ndarray                 # (many, len) int8
    molc: int
    names: list[str] = dataclasses.field(default_factory=list)
    weight: np.ndarray | None = None  # (many,)
    exgl: bool = False
    exgr: bool = False
    tgapf: float = 1.0
    # per-member intron junction positions in ungapped member-local tron
    # coordinates (msa/sigii.py; reference SigII gsinfo.h:41-99)
    eij: list | None = None

    # derived, built by prepare()
    eff_codes: np.ndarray | None = None
    cfq: np.ndarray | None = None     # (len+2,) [-1..len] thickness
    dfq: np.ndarray | None = None
    efq: np.ndarray | None = None
    gdens: np.ndarray | None = None   # (len, many) gapdensity
    pgdens: np.ndarray | None = None  # (len, many) postgapdensity
    freq: np.ndarray | None = None    # (len, dim)
    eijdns: np.ndarray | None = None  # (len+1, 3) junction phase density

    @property
    def many(self) -> int:
        return self.codes.shape[0]

    @property
    def step(self) -> int:
        return 3 if self.molc == ab.PROTEIN else 1

    @property
    def length(self) -> int:
        return self.codes.shape[1]

    @property
    def sumwt(self) -> float:
        w = self.weight if self.weight is not None else np.ones(self.many)
        return float(w.sum())

    def has_internal_gaps(self) -> bool:
        return bool((self.eff_if() == GAP).any())

    def eff_if(self):
        return self.eff_codes if self.eff_codes is not None else self.codes

    # ------------------------------------------------------------------
    def prepare(self, dim: int) -> "Msa":
        """Build all derived arrays.  ``dim`` = substitution matrix size."""
        many, L = self.codes.shape
        w = (self.weight if self.weight is not None
             else np.ones(many)).astype(np.float64)

        # --- exg_seq: rewrite terminal gap runs -------------------------
        eff = self.codes.copy()
        gl = self.exgl or self.tgapf < 1.0
        gr = self.exgr or self.tgapf < 1.0
        # terminal run boundaries per member
        first_res = np.full(many, L, np.int64)
        last_res = np.full(many, -1, np.int64)
        for i in range(many):
            nz = np.nonzero(self.codes[i] > GAP)[0]
            if nz.size:
                first_res[i], last_res[i] = nz[0], nz[-1]
            if gl and nz.size:
                eff[i, :first_res[i]] = NIL
            elif gl:
                eff[i, :] = NIL
            if gr and nz.size:
                eff[i, last_res[i] + 1:] = NIL
        self.eff_codes = eff

        # --- thickness (mkthick) ---------------------------------------
        ltg = 0.0 if self.exgl else self.tgapf
        rtg = 0.0 if self.exgr else self.tgapf
        sumwt = w.sum()
        cfq = np.zeros(L + 2)
        dfq = np.zeros(L + 2)
        efq = np.zeros(L + 2)
        is_res = eff > GAP
        is_gap = eff == GAP
        is_nil = eff == NIL
        in_lterm = (np.arange(L)[None, :] < first_res[:, None])
        in_rterm = (np.arange(L)[None, :] > last_res[:, None])
        # cfq = weighted residues; dfq = gaps + discounted nils
        cfq[1:L + 1] = (is_res * w[:, None]).sum(0)
        nil_w = (is_nil & in_lterm) * (ltg * w[:, None]) + \
                (is_nil & in_rterm) * (rtg * w[:, None])
        dfq[1:L + 1] = (is_gap * w[:, None]).sum(0) + nil_w.sum(0)
        # efq: internally sumwt; in terminal regions cfq+dfq
        efq[1:L + 1] = cfq[1:L + 1] + dfq[1:L + 1]
        # boundaries: thk[-1] = {0, sumwt*ltg, sumwt*ltg},
        #             thk[len] = {0, sumwt*rtg, 0}
        cfq[0] = 0.0
        dfq[0] = efq[0] = sumwt * ltg
        cfq[L + 1] = efq[L + 1] = 0.0
        dfq[L + 1] = sumwt * rtg
        self.cfq, self.dfq, self.efq = cfq, dfq, efq

        # --- gap densities ---------------------------------------------
        # gapdensity: 0 for residue; 1 for true gap; ltg/rtg for nil runs
        gd = np.zeros((L, many))
        gd[is_gap.T] = 1.0
        gd += ((is_nil & in_lterm) * ltg + (is_nil & in_rterm) * rtg).T
        self.gdens = gd
        # postgapdensity at column c for member i:
        #   ltg if eff[i,c]==nil and c < first_res (before first residue)
        #   rtg if eff[i,c+1]==nil and c >= first_res (at/after last run)
        #   else 1
        pg = np.ones((L, many))
        next_nil = np.concatenate(
            [is_nil[:, 1:], np.ones((many, 1), bool)], axis=1)
        cond_l = (is_nil & in_lterm).T
        cond_r = (next_nil & ~in_lterm).T
        pg[cond_l] = ltg
        pg[~cond_l & cond_r] = rtg
        self.pgdens = pg

        # --- frequency vectors -----------------------------------------
        fr = np.zeros((L, dim), np.float32)
        for i in range(many):
            np.add.at(fr, (np.arange(L), eff[i].astype(np.int64)), w[i])
        self.freq = fr

        # --- intron junction densities (SigII dns) ----------------------
        if self.eij is not None:
            from . import sigii
            self.eijdns = sigii.eij_density(self.codes, self.eij,
                                            self.weight, self.step)
        return self


def msa_from_strings(rows: list[str], molc: int,
                     names: list[str] | None = None) -> Msa:
    codes = np.stack([ab.encode(r, molc) for r in rows])
    return Msa(codes=codes, molc=molc, names=names or
               [f"seq{i}" for i in range(len(rows))])


def single(seq_codes: np.ndarray, molc: int, name: str = "seq",
           eij=None) -> Msa:
    return Msa(codes=seq_codes[None, :].astype(np.int8), molc=molc,
               names=[name], eij=None if eij is None else [eij])
