"""Banded group-to-group profile DP and its traceback (kernels K2, K3).

Counterpart of ``prrn_aln_tpu/ops/group.py``.  The packers
(``_pack_profiles``, ``_pack_cols``, ``_bonus_images``,
``uniform_side``, ``effective_members``, ``skl_in_band``,
``_moves_to_skl``, ``_bucket``) are copied unchanged.  The plain
versions ``wavefront_core_ref`` (of ``_wavefront_core`` with the
``_wavefront_from_profiles`` score image) and ``traceback_ref`` (of
``_traceback_device``) and ``traceback_range_ref`` (of
``_traceback_device_range``) sit beside the dispatching wrappers
``group_wavefront`` (CUDA kernel ``csrc/group_wavefront.cu``, which
replaces ``ops/pallas_group.py::_kernel``, resumable carries included)
and ``traceback``/``traceback_range`` (CUDA kernel
``csrc/traceback.cu``).  ``group_align`` and ``group_align_batch`` keep
the corner-miss retry at sh=-100; ``group_align_batch`` splits its batch
over the ranks of a ``torch.distributed`` ``group`` (the JAX package's
``mesh``) and records the split in ``LAST_BATCH_SHARD``;
``group_align_linear`` is the linear-space aligner, chunks of the
wavefront resumed from checkpointed carries.

One anti-diagonal step updates every band slot whose parity matches
the diagonal; per-slot state carries the H/G/F lane values (plus G2/F2
for the double-affine ``ls3`` mode) and per-member gap-run lengths, so
the exact pairwise gap-open counts (crg) are sums over member pairs.

Sums of products (the crg member-pair sums and the profile score
S = CA @ CB.T) are taken in one fixed order, a running sum in which
each term is added as a fused multiply-add: the order and rounding that
XLA uses on the CPU for the JAX package's reference.  The fused step is
computed as an f64 multiply (exact for f32 operands) and an f64 add
rounded to f32, identically by the plain versions and the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..msa.msa import Msa
from ..msa import sshp as _sshp
from ..utils import trace
from . import _build
from .frontier import gather_blocks, shard_block
from .window import Window, stripe
from .group_np import _col_arrays, DIAG, VERT, HORI, VERT2, HORI2

NEVSEL = -1.0e30
# (rank, world, start, stop) of the last group_align_batch call's block
LAST_BATCH_SHARD = None

# H dir codes (match group_np)
D_DEAD, D_DIAG, D_VERT, D_HORI = 0, 1, 2, 3


def _bucket(x: int, q: int = 64) -> int:
    return ((x + q - 1) // q) * q


def _bonus_images(A: Msa, B: Msa, la_max: int, lb_max: int, spb: float,
                  scale: float = 1.0):
    """Intron-position bonus images (fwd2c.h:306-312): BD (all phases,
    folded into the diagonal score image) and B0 (phase 0, applied to the
    winning gap lane)."""
    B0 = np.zeros((la_max, lb_max), np.float32)
    BD = None
    if spb > 0 and A.eijdns is not None and B.eijdns is not None:
        EA = A.eijdns[:A.length]
        EB = B.eijdns[:B.length]
        BD = (scale * spb) * (EA @ EB.T)
        B0[:A.length, :B.length] = (scale * spb) * np.outer(EA[:, 0],
                                                            EB[:, 0])
    return BD, B0


NSHP = 6      # max sshp propensity channels (sshp.py SsHpPrm.factors)
NEIJ = 3      # intron phase channels (msa.eijdns)


def _pack_profiles(A: Msa, B: Msa, mtx, la_max: int, lb_max: int,
                   spb: float = 0.0, scale: float = 1.0):
    """Channel stacks for the on-device score-image build.

    S = CA @ CB.T reproduces  freqA*mtx*freqB^T  (profile similarity,
    mseq.cc:413-435 VECPRO x frequency)  +  scale*spb*(EA @ EB^T)  (all-
    phase intron-position bonus, fwd2c.h:306-312)  +  sshp channels
    (maln2.cc:1778-1792); ea0/eb0 give the phase-0 gap-lane bonus outer
    product.  Only these O(L x C) stacks cross the host->device link —
    the O(La*Lb) image is built by the MXU in
    ``_wavefront_from_profiles``.
    """
    dim = mtx.shape[1]
    C = dim + NEIJ + NSHP
    La, Lb = A.length, B.length
    CA = np.zeros((la_max, C), np.float32)
    CB = np.zeros((lb_max, C), np.float32)
    CA[:La, :dim] = (A.freq.astype(np.float64)
                     @ mtx.astype(np.float64)).astype(np.float32)
    CB[:Lb, :dim] = B.freq.astype(np.float32)
    ea0 = np.zeros(la_max, np.float32)
    eb0 = np.zeros(lb_max, np.float32)
    if spb > 0 and A.eijdns is not None and B.eijdns is not None:
        EA = A.eijdns[:La]
        EB = B.eijdns[:Lb]
        k = min(EA.shape[1], NEIJ)
        CA[:La, dim:dim + k] = (scale * spb) * EA[:, :k]
        CB[:Lb, dim:dim + k] = EB[:, :k]
        ea0[:La] = (scale * spb) * EA[:, 0]
        eb0[:Lb] = EB[:, 0]
    ss = _sshp.pair_channels(A, B)
    if ss is not None:
        qa, qb = ss
        k2 = min(qa.shape[1], NSHP)
        CA[:La, dim + NEIJ:dim + NEIJ + k2] = qa[:, :k2]
        CB[:Lb, dim + NEIJ:dim + NEIJ + k2] = qb[:, :k2]
    return CA, CB, ea0, eb0


def uniform_side(msa: Msa) -> bool:
    """Gap-free group: internal gap columns are absent, so every
    member's gap-run length is identical along any DP path (runs only
    come from DP-inserted gaps, which advance uniformly).  The exact
    pairwise crg accounting then collapses to weighted column sums --
    the reference's no-internal-gap DPunit closed form (fwd2c.cc
    DPunit vs DPunit_nv; tier auto-selection maln2.cc:43-60
    advised_sim2).  Collapsing turns the (an*bn) per-cell gap-open
    work and the 10*an VMEM gap-run state into O(1) per slot."""
    import os
    if os.environ.get("PRRN_GROUP_UNIFORM", "1") == "0":
        return False
    from .. import alphabet as ab
    return msa.many > 1 and bool(np.all(msa.codes > ab.GAP))


def effective_members(msa: Msa) -> int:
    return 1 if uniform_side(msa) else msa.many


def _pack_cols(A: Msa, B: Msa, pa: int, pb: int, la_max: int, lb_max: int,
               ua: bool = False, ub: bool = False):
    """Padded per-column gap/thickness arrays + member weights
    (the non-image operands of the wavefront kernel).  ``ua``/``ub``
    collapse a gap-free side to one effective member (see
    uniform_side): every member factor enters the crg sums linearly,
    so the weighted column sums are exact."""
    na_a, gda, pga = _col_arrays(A)
    na_b, gdb, pgb = _col_arrays(B)
    an, bn = A.many, B.many
    w_a = (A.weight if A.weight is not None else np.ones(an)) \
        .astype(np.float64)
    w_b = (B.weight if B.weight is not None else np.ones(bn)) \
        .astype(np.float64)
    if ua:
        na_a = (na_a * w_a).sum(1, keepdims=True).astype(np.float32)
        gda = (gda * w_a).sum(1, keepdims=True).astype(np.float32)
        pga = (pga * w_a).sum(1, keepdims=True).astype(np.float32)
        an = 1
    if ub:
        na_b = (na_b * w_b).sum(1, keepdims=True).astype(np.float32)
        gdb = (gdb * w_b).sum(1, keepdims=True).astype(np.float32)
        pgb = (pgb * w_b).sum(1, keepdims=True).astype(np.float32)
        bn = 1

    def padc(x, rows, cols):
        out = np.zeros((rows, cols), np.float32)
        out[:x.shape[0], :x.shape[1]] = x
        return out

    na_a, gda, pga = (padc(x, la_max + 1, pa) for x in (na_a, gda, pga))
    na_b, gdb, pgb = (padc(x, lb_max + 1, pb) for x in (na_b, gdb, pgb))
    na_a[:, an:] = 1.0
    pga[:, an:] = 1.0
    na_b[:, bn:] = 1.0
    pgb[:, bn:] = 1.0

    def pad1(x, rows):
        out = np.zeros(rows, np.float32)
        out[:x.shape[0]] = x
        return out

    cfa = pad1(A.cfq[:A.length + 1], la_max + 1)
    efa = pad1(A.efq[:A.length + 1], la_max + 1)
    cfb = pad1(B.cfq[:B.length + 1], lb_max + 1)
    efb = pad1(B.efq[:B.length + 1], lb_max + 1)
    wa = np.zeros(pa, np.float32)
    wa[:an] = 1.0 if ua else (
        A.weight if A.weight is not None else np.ones(an))
    wb = np.zeros(pb, np.float32)
    wb[:bn] = 1.0 if ub else (
        B.weight if B.weight is not None else np.ones(bn))
    return na_a, gda, pga, na_b, gdb, pgb, cfa, efa, cfb, efb, wa, wb


def skl_in_band(skl, lw: int, up: int) -> bool:
    """True iff every cell of the path lies inside the stripe.  Segment
    interiors stay between their endpoint diagonals, so endpoint checks
    suffice."""
    return all(lw <= n - m <= up for m, n in skl)


def _moves_to_skl(moves, La: int, Lb: int):
    """Forward move list (DIAG/VERT/HORI) -> SKL vertex list."""
    skl = [(0, 0)]
    mm = nn = 0
    prev = None
    for mv in moves:
        if prev is not None and mv != prev:
            skl.append((mm, nn))
        if mv == DIAG:
            mm += 1
            nn += 1
        elif mv == VERT:
            mm += 1
        else:
            nn += 1
        prev = mv
    skl.append((La, Lb))
    return skl


def _fma(a, b, c):
    """a * b + c rounded once to f32 (an f64 product is exact for f32
    factors; the f64 sum is rounded to f32)."""
    return (a.double() * b.double() + c.double()).float()


def _fma_sum(terms, acc=None):
    """Running sum of f64 products (exact for f32 factors), each added
    to the f32 accumulator in f64 and rounded to f32."""
    for t in terms:
        acc = t.float() if acc is None else (acc + t).float()
    return acc


def profile_scores_ref(CA: torch.Tensor, CB: torch.Tensor) -> torch.Tensor:
    """S[b] = CA[b] @ CB[b].T, summed over the channels in order."""
    ca = CA.double()
    cb = CB.double()
    return _fma_sum(ca[:, :, None, c] * cb[:, None, :, c]
                    for c in range(CA.shape[2]))


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, L, K) gathered at idx (B, R) -> (B, R, K)."""
    return x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[2]))


def _trim_members(w: torch.Tensor) -> int:
    """Members past the last non-zero weight of every pair add only zero
    terms to the crg sums, so the plain version leaves them out."""
    nz = (w != 0).any(0).nonzero()
    return int(nz.max()) + 1 if nz.numel() else 1


class Carry(NamedTuple):
    """The wavefront's state between two steps, per pair: the lane values
    H, G, F, G2, F2 (B, 5, nslot) f32, Hdir (B, nslot) int8 and the gap
    runs (B, lanes * (an + bn), nslot + 2) int32 (3 lanes, 5 with ls3;
    an, bn the batch's largest real member counts, ``member_counts``).
    Run row ``lane * an + i`` is member i of A, ``lanes * an + lane * bn
    + j`` member j of B, lanes in the order GH, GG, GF, GG2, GF2; slot k
    is column k + 1, and columns 0 and nslot + 1 are 0.  Rows past a
    pair's real members are carried through untouched."""
    vals: torch.Tensor
    hdir: torch.Tensor
    runs: torch.Tensor


def init_carry(lw, nslot: int, an: int, bn: int, ls3: bool = False,
               device="cpu") -> Carry:
    """The DP corner as a carry (``pallas_group.init_state``): H = 0 and
    Hdir = D_DIAG on diagonal r = 0, every other lane value NEVSEL, every
    run 0.  ``lw`` (B,) the pairs' lower diagonals."""
    lw = torch.as_tensor(lw, dtype=torch.long, device=device).reshape(-1)
    r = lw[:, None] - 1 + torch.arange(nslot, device=device)[None, :]
    vals = torch.full((lw.numel(), 5, nslot), NEVSEL, dtype=torch.float32,
                      device=device)
    vals[:, 0] = torch.where(r == 0, 0.0, NEVSEL)
    hdir = torch.where(r == 0, D_DIAG, 0).to(torch.int8)
    runs = torch.zeros((lw.numel(), (5 if ls3 else 3) * (an + bn),
                        nslot + 2), dtype=torch.int32, device=device)
    return Carry(vals, hdir, runs)


def carry_equal(a: Carry, b: Carry) -> bool:
    """Bit for bit (lane values compared as their bits)."""
    return (torch.equal(a.vals.view(torch.int32), b.vals.view(torch.int32))
            and torch.equal(a.hdir, b.hdir) and torch.equal(a.runs, b.runs))


def wavefront_core_ref(S, B0, na_a, gda, pga, na_b, gdb, pgb,
                       cfa, efa, cfb, efb, wa, wb, la, lb, lw, up,
                       u, gop_scale, v2divv1, u2divu1, k1,
                       *, nslot: int, nsteps: int, ls3: bool = False,
                       d0: int = 0, carry: Carry | None = None):
    """Plain PyTorch group wavefront over a batch of B pairs.

    S, B0 (B, la_max, lb_max) f32 score image and phase-0 intron bonus;
    na_a/gda/pga (B, la_max+1, an) and na_b/gdb/pgb (B, lb_max+1, bn)
    column arrays (row 0 = boundary); cfa/efa (B, la_max+1), cfb/efb
    (B, lb_max+1); wa (B, an), wb (B, bn); la, lb, lw, up, k1 (B,) int;
    u, gop_scale, v2divv1, u2divu1 (B,) f32.  Runs steps d0 to
    d0 + nsteps - 1 from ``carry`` (None: the DP corner).  Returns score
    (B,) f32 (read from the final state), dirs and opens (B, nsteps,
    nslot) int8 (row i: step d0 + i) and the final state as a ``Carry``.
    """
    dev = S.device
    f32, i32, i8 = torch.float32, torch.int32, torch.int8
    Bn, la_max, lb_max = S.shape
    ca, cb = member_counts(wa), member_counts(wb)
    an = _trim_members(wa)
    bn = _trim_members(wb)
    nl = 5 if ls3 else 3
    na_a, gda, pga = (x[:, :, :an] for x in (na_a, gda, pga))
    na_b, gdb, pgb = (x[:, :, :bn] for x in (na_b, gdb, pgb))
    wa, wb = wa[:, None, :an], wb[:, None, :bn]
    la, lb, lw, up, k1 = (x.long()[:, None] for x in (la, lb, lw, up, k1))
    u, gop_scale, v2divv1, u2divu1 = (
        x.to(f32)[:, None] for x in (u, gop_scale, v2divv1, u2divu1))
    neg_u = -u
    r_all = lw - 1 + torch.arange(nslot, device=dev)[None, :]

    def full(val, *shape, dtype=f32):
        return torch.full((Bn, nslot) + shape, val, dtype=dtype, device=dev)

    if carry is None:
        carry = init_carry(lw.reshape(-1), nslot, an, bn, ls3, dev)
    want = {"vals": ((Bn, 5, nslot), f32), "hdir": ((Bn, nslot), i8),
            "runs": ((Bn, nl * (an + bn), nslot + 2), i32)}
    for name, (shape, dtype) in want.items():
        t = getattr(carry, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"carry.{name}: {tuple(t.shape)} {t.dtype}, "
                             f"expected {shape} {dtype}")
    Hval, Gval, Fval, G2val, F2val = carry.vals.to(dev).unbind(1)
    Hdir = carry.hdir.to(dev)
    rows = carry.runs.to(dev)[:, :, 1:nslot + 1].transpose(1, 2)
    zeros_a, zeros_b = full(0, an, dtype=i32), full(0, bn, dtype=i32)
    gla = [rows[:, :, ln * an:(ln + 1) * an] for ln in range(nl)]
    glb = [rows[:, :, nl * an + ln * bn:nl * an + (ln + 1) * bn]
           for ln in range(nl)]
    Hgla, Ggla, Fgla, G2gla, F2gla = gla + [zeros_a] * (5 - nl)
    Hglb, Gglb, Fglb, G2glb, F2glb = glb + [zeros_b] * (5 - nl)
    agap = na_a <= 0.0
    bgap = na_b <= 0.0
    Sflat = S.reshape(Bn, -1)
    B0flat = B0.reshape(Bn, -1)

    def lo(x, fill):
        pad = torch.full_like(x[:, :1], fill)
        return torch.cat([pad, x[:, :-1]], 1)

    def hi(x, fill):
        pad = torch.full_like(x[:, :1], fill)
        return torch.cat([x[:, 1:], pad], 1)

    def pair_sum(x, ge, y):
        """sum_i sum_j x_i * [ge_ij] * y_j, in order (i outer, j inner)."""
        prod = (x.double()[:, :, :, None] * ge
                * y.double()[:, :, None, :]).reshape(Bn, nslot, -1)
        return _fma_sum(prod.unbind(2))

    dirs_out = torch.empty((Bn, nsteps, nslot), dtype=i8, device=dev)
    opens_out = torch.empty((Bn, nsteps, nslot), dtype=i8, device=dev)

    for i in range(nsteps):
        d = d0 + i
        m_vec = (d - r_all) >> 1
        n_vec = d - m_vec
        valid = (((d - r_all) % 2 == 0) & (m_vec >= 0) & (m_vec <= la)
                 & (n_vec >= 0) & (n_vec <= lb)
                 & (r_all >= lw) & (r_all <= up) & (d > 0))
        mc = m_vec.clamp(0, la_max)
        nc = n_vec.clamp(0, lb_max)
        is_top = m_vec == 0
        is_left = n_vec == 0
        a_gap_col = _rows(agap, mc)
        b_gap_col = _rows(bgap, nc)
        cell = ((m_vec - 1).clamp(0, la_max - 1) * lb_max
                + (n_vec - 1).clamp(0, lb_max - 1))
        s_cell = Sflat.gather(1, cell)
        b0_cell = torch.where((m_vec >= 1) & (n_vec >= 1),
                              B0flat.gather(1, cell), 0.0)
        ppa = cfa.gather(1, mc) * efb.gather(1, nc)
        ppb = cfb.gather(1, nc) * efa.gather(1, mc)
        xa_na = wa * _rows(na_a, mc)
        xa_gd = wa * _rows(gda, mc)
        xa_pg = wa * _rows(pga, mc)
        yb_na = wb * _rows(na_b, nc)
        yb_gd = wb * _rows(gdb, nc)
        yb_pg = wb * _rows(pgb, nc)

        def crg(gla, glb, d3):
            """Weighted new-gap count before the gop_scale factor."""
            ge = gla[:, :, :, None] >= glb[:, :, None, :]
            le = glb[:, :, None, :] >= gla[:, :, :, None]
            if d3 == 0:
                return (pair_sum(xa_na, ge, yb_gd)
                        + pair_sum(xa_gd, le, yb_na))
            if d3 > 0:
                return pair_sum(xa_na, ge, yb_pg)
            return pair_sum(xa_pg, le, yb_na)

        Hval_lo, Hdir_lo = lo(Hval, NEVSEL), lo(Hdir, 0)
        Hgla_lo, Hglb_lo = lo(Hgla, 0), lo(Hglb, 0)
        Hval_hi, Hdir_hi = hi(Hval, NEVSEL), hi(Hdir, 0)
        Hgla_hi, Hglb_hi = hi(Hgla, 0), hi(Hglb, 0)
        Gval_hi, Ggla_hi, Gglb_hi = hi(Gval, NEVSEL), hi(Ggla, 0), hi(Gglb, 0)
        Fval_lo, Fgla_lo, Fglb_lo = lo(Fval, NEVSEL), lo(Fgla, 0), lo(Fglb, 0)

        # Where XLA on the CPU evaluates `x + a * b` of the JAX expressions
        # as one fused multiply-add, the plain version does too (_fma):
        # always for the crg sums times gop_scale and the ls3 factors, but
        # not where the product also feeds another product (gop_v and
        # gop_h under ls3), nor for the + pua / + pub terms.
        # diagonal candidate (pred: same slot, step d-2)
        d_val = _fma(crg(Hgla, Hglb, 0), gop_scale, Hval + s_cell)
        d_gla = torch.where(a_gap_col, Hgla + 1, 0)
        d_glb = torch.where(b_gap_col, Hglb + 1, 0)

        # vertical lane
        rgop_v = crg(Hgla_hi, Hglb_hi, 1)
        ext_gv = _fma(crg(Ggla_hi, Gglb_hi, 1), gop_scale, Gval_hi)
        if ls3:      # the product gop_v also feeds the G2 lane
            gop_v = rgop_v * gop_scale
            open_gv = Hval_hi + gop_v
        else:
            open_gv = _fma(rgop_v, gop_scale, Hval_hi)
        open_v = (Hdir_hi != D_VERT) & (open_gv > ext_gv)
        pua = ppa * neg_u
        gv = torch.where(open_v, open_gv, ext_gv) + pua
        g_gla = torch.where(a_gap_col, torch.where(
            open_v[:, :, None], Hgla_hi, Ggla_hi) + 1, 0)
        g_glb = torch.where(open_v[:, :, None], Hglb_hi, Gglb_hi) + 1
        vert_ok = m_vec >= 2
        gv = torch.where(vert_ok, gv, NEVSEL)

        # horizontal lane
        rgop_h = crg(Hgla_lo, Hglb_lo, -1)
        ext_fv = _fma(crg(Fgla_lo, Fglb_lo, -1), gop_scale, Fval_lo)
        if ls3:
            gop_h = rgop_h * gop_scale
            open_fv = Hval_lo + gop_h
        else:
            open_fv = _fma(rgop_h, gop_scale, Hval_lo)
        open_h = (Hdir_lo != D_HORI) & (open_fv > ext_fv)
        pub = ppb * neg_u
        fv = torch.where(open_h, open_fv, ext_fv) + pub
        f_gla = torch.where(open_h[:, :, None], Hgla_lo, Fgla_lo) + 1
        f_glb = torch.where(b_gap_col, torch.where(
            open_h[:, :, None], Hglb_lo, Fglb_lo) + 1, 0)
        hori_ok = n_vec >= 2
        fv = torch.where(hori_ok, fv, NEVSEL)

        # boundary chains: top row is a forced horizontal chain, left
        # column a forced vertical one
        top_val = open_fv + pub
        left_val = open_gv + pua

        # long-gap lanes (ls=3)
        if ls3:
            G2val_hi, G2gla_hi, G2glb_hi = (hi(G2val, NEVSEL), hi(G2gla, 0),
                                            hi(G2glb, 0))
            F2val_lo, F2gla_lo, F2glb_lo = (lo(F2val, NEVSEL), lo(F2gla, 0),
                                            lo(F2glb, 0))
            open_g2v = _fma(v2divv1, gop_v, Hval_hi)
            ext_g2v = _fma(v2divv1, crg(G2gla_hi, G2glb_hi, 1) * gop_scale,
                           G2val_hi)
            open_v2 = (Hdir_hi != D_VERT) & (open_g2v > ext_g2v)
            g2v = _fma(u2divu1, pua, torch.where(open_v2, open_g2v, ext_g2v))
            g2_gla = torch.where(a_gap_col, torch.where(
                open_v2[:, :, None], Hgla_hi, G2gla_hi) + 1, 0)
            g2_glb = torch.where(open_v2[:, :, None], Hglb_hi, G2glb_hi) + 1
            g2v = torch.where(vert_ok, g2v, NEVSEL)

            open_f2v = _fma(v2divv1, gop_h, Hval_lo)
            ext_f2v = _fma(v2divv1, crg(F2gla_lo, F2glb_lo, -1) * gop_scale,
                           F2val_lo)
            open_h2 = (Hdir_lo != D_HORI) & (open_f2v > ext_f2v)
            f2v = _fma(u2divu1, pub, torch.where(open_h2, open_f2v, ext_f2v))
            f2_gla = torch.where(open_h2[:, :, None], Hgla_lo, F2gla_lo) + 1
            f2_glb = torch.where(b_gap_col, torch.where(
                open_h2[:, :, None], Hglb_lo, F2glb_lo) + 1, 0)
            f2v = torch.where(hori_ok, f2v, NEVSEL)

            # terminal runs >= k1 accrue at the long-gap rates
            top_val = torch.where(n_vec >= k1, _fma(u2divu1, pub, open_f2v),
                                  top_val)
            left_val = torch.where(m_vec >= k1,
                                   _fma(u2divu1, pua, open_g2v), left_val)

        # select (lane order: g, g2 strict, f ties, f2 ties)
        mx_val = gv
        mx_lane = torch.full_like(Hdir, VERT)
        if ls3:
            t = g2v > mx_val
            mx_val = torch.where(t, g2v, mx_val)
            mx_lane = torch.where(t, VERT2, mx_lane).to(i8)
        t = fv >= mx_val
        mx_val = torch.where(t, fv, mx_val)
        mx_lane = torch.where(t, HORI, mx_lane).to(i8)
        if ls3:
            t = f2v >= mx_val
            mx_val = torch.where(t, f2v, mx_val)
            mx_lane = torch.where(t, HORI2, mx_lane).to(i8)
        # the phase-0 intron bonus lands on the winning gap lane and
        # persists in its stored value
        has_b0 = (b0_cell != 0.0) & (mx_val > NEVSEL / 2)
        mx_val = torch.where(has_b0, mx_val + b0_cell, mx_val)
        gv = torch.where(has_b0 & (mx_lane == VERT), gv + b0_cell, gv)
        fv = torch.where(has_b0 & (mx_lane == HORI), fv + b0_cell, fv)
        if ls3:
            g2v = torch.where(has_b0 & (mx_lane == VERT2), g2v + b0_cell,
                              g2v)
            f2v = torch.where(has_b0 & (mx_lane == HORI2), f2v + b0_cell,
                              f2v)
        nondiag = mx_val > d_val
        is_vlane = (mx_lane == VERT) | (mx_lane == VERT2)
        h_val = torch.where(nondiag, mx_val, d_val)
        h_dir = torch.where(nondiag, torch.where(is_vlane, D_VERT, D_HORI),
                            D_DIAG).to(i8)
        h_src = torch.where(nondiag, mx_lane, DIAG).to(i8)

        def by_lane(g, g2, f, f2):
            lane = mx_lane[:, :, None]
            if not ls3:
                return torch.where(lane == VERT, g, f)
            return torch.where(lane == VERT, g, torch.where(
                lane == VERT2, g2, torch.where(lane == HORI, f, f2)))

        mx_gla = by_lane(g_gla, g2_gla if ls3 else None, f_gla,
                         f2_gla if ls3 else None)
        mx_glb = by_lane(g_glb, g2_glb if ls3 else None, f_glb,
                         f2_glb if ls3 else None)
        nd3 = nondiag[:, :, None]
        h_gla = torch.where(nd3, mx_gla, d_gla)
        h_glb = torch.where(nd3, mx_glb, d_glb)

        # overlay boundary chains
        h_val = torch.where(is_top, top_val,
                            torch.where(is_left, left_val, h_val))
        h_dir = torch.where(is_top, D_HORI,
                            torch.where(is_left, D_VERT, h_dir)).to(i8)
        h_src = torch.where(is_top, HORI,
                            torch.where(is_left, VERT, h_src)).to(i8)
        top3, left3 = is_top[:, :, None], is_left[:, :, None]
        h_gla = torch.where(top3, Hgla_lo + 1, torch.where(
            left3, torch.where(a_gap_col, Hgla_hi + 1, 0), h_gla))
        h_glb = torch.where(top3, torch.where(b_gap_col, Hglb_lo + 1, 0),
                            torch.where(left3, Hglb_hi + 1, h_glb))

        # masked writeback
        vm = valid
        vm3 = vm[:, :, None]
        inner = vm & ~is_top & ~is_left
        Hval = torch.where(vm, h_val, Hval)
        Hdir = torch.where(vm, h_dir, Hdir)
        Hgla = torch.where(vm3, h_gla, Hgla)
        Hglb = torch.where(vm3, h_glb, Hglb)
        Gval = torch.where(vm, torch.where(inner, gv, NEVSEL), Gval)
        Ggla = torch.where(vm3, g_gla, Ggla)
        Gglb = torch.where(vm3, g_glb, Gglb)
        Fval = torch.where(vm, torch.where(inner, fv, NEVSEL), Fval)
        Fgla = torch.where(vm3, f_gla, Fgla)
        Fglb = torch.where(vm3, f_glb, Fglb)
        opens = (vm & open_v).to(i8) + 2 * (vm & open_h).to(i8)
        if ls3:
            G2val = torch.where(vm, torch.where(inner, g2v, NEVSEL), G2val)
            G2gla = torch.where(vm3, g2_gla, G2gla)
            G2glb = torch.where(vm3, g2_glb, G2glb)
            F2val = torch.where(vm, torch.where(inner, f2v, NEVSEL), F2val)
            F2gla = torch.where(vm3, f2_gla, F2gla)
            F2glb = torch.where(vm3, f2_glb, F2glb)
            opens = (opens + 4 * (vm & open_v2).to(i8)
                     + 8 * (vm & open_h2).to(i8))
        dirs_out[:, i] = torch.where(vm, h_src, -1)
        opens_out[:, i] = opens

    score = torch.where(r_all == lb - la, Hval, NEVSEL).amax(1)
    # the runs back into the carry's rows, a pair's rows past its real
    # members as they came in
    real = torch.cat(
        [torch.arange(an, device=dev)[None, :] < ca[:, None]] * nl
        + [torch.arange(bn, device=dev)[None, :] < cb[:, None]] * nl, 1)
    runs = torch.nn.functional.pad(torch.cat(
        [x.transpose(1, 2) for x in (Hgla, Ggla, Fgla, G2gla, F2gla)[:nl]
         + (Hglb, Gglb, Fglb, G2glb, F2glb)[:nl]], 1), (1, 1))
    runs = torch.where(real[:, :, None], runs, carry.runs.to(dev))
    out = Carry(torch.stack([Hval, Gval, Fval, G2val, F2val], 1), Hdir,
                runs.contiguous())
    return score, dirs_out, opens_out, out


# inputs of the group wavefront, in the order _pack_inputs builds them
_FIELDS = ("CA", "CB", "ea0", "eb0", "na_a", "gda", "pga", "na_b", "gdb",
           "pgb", "cfa", "efa", "cfb", "efb", "wa", "wb")
_IFIELDS = ("la", "lb", "lw", "up", "k1")
_FFIELDS = ("u", "gop_scale", "v2divv1", "u2divu1")


def stack_inputs(items: list[dict], device) -> dict:
    """Stack per-pair packed inputs (``_pack_inputs``) into batched
    tensors on ``device``."""
    out = {}
    with trace.span("prrn.group.pack"):
        for k in _FIELDS:
            out[k] = trace.h2d(torch.as_tensor(
                np.stack([it[k] for it in items]), dtype=torch.float32,
                device=device))
        for k in _IFIELDS:
            out[k] = trace.h2d(torch.as_tensor(
                np.array([it[k] for it in items]), dtype=torch.int32,
                device=device))
        for k in _FFIELDS:
            out[k] = trace.h2d(torch.as_tensor(
                np.array([it[k] for it in items]), dtype=torch.float32,
                device=device))
    return out


def group_wavefront_ref(ins: dict, *, nslot: int, nsteps: int,
                        ls3: bool = False, d0: int = 0,
                        carry: Carry | None = None):
    """Plain version of kernel K2: build S and B0, then run
    ``wavefront_core_ref``."""
    S = profile_scores_ref(ins["CA"], ins["CB"])
    B0 = ins["ea0"][:, :, None] * ins["eb0"][:, None, :]
    return wavefront_core_ref(
        S, B0, *(ins[k] for k in _FIELDS[4:]),
        *(ins[k] for k in ("la", "lb", "lw", "up")),
        *(ins[k] for k in _FFIELDS), ins["k1"],
        nslot=nslot, nsteps=nsteps, ls3=ls3, d0=d0, carry=carry)


# shared memory a block can take on the H100 (bytes)
SMEM_MAX = 232448
# steps whose profile scores K2 computes at once (kSpan in the kernel)
K2_SPAN = 8
# K2's threads a block (kMaxThreads) and CTAs a cluster of its cluster
# variant (kClusterMax, the non-portable most on the H100)
K2_THREADS = 512
K2_CLUSTER_MAX = 16
# bytes of a gap-run word in K2's shared memory, by where the runs live
# (the kernel's run_bytes; "device": int32 in the output carry)
RUN_BYTES = {"shared16": 2, "shared32": 4, "device": 0}


def member_counts(w: torch.Tensor) -> torch.Tensor:
    """Per pair, the members up to the last non-zero weight (at least
    one): the members K2 walks.  The members past it are padding and add
    only exact zeros to the crg sums."""
    idx = torch.arange(1, w.shape[1] + 1, dtype=torch.int32,
                       device=w.device)
    return torch.where(w != 0, idx, 0).amax(1).clamp_min(1).to(torch.int32)


def cluster_shape(an_max: int, bn_max: int, nslot: int, la_max: int,
                  lb_max: int, ls3: bool,
                  ctas: int | None = None) -> dict | None:
    """The cluster variant's shape for a launch, or None where it does
    not fit.

    CTA r of a pair's cluster of ``ctas`` takes slot pairs ``r * npairs
    // ctas`` to ``(r + 1) * npairs // ctas - 1``; each CTA's shared
    memory holds the profile scores of the next ``K2_SPAN`` steps of its
    ``pairs_per_cta`` slot pairs (f32), and over their slots and a halo
    slot each side the lane values and Hdir (21 bytes a slot) and, where
    they fit, the gap runs: as int16 where no run can pass int16
    ("shared16"), else as int32 ("shared32"); where they do not fit,
    "device": int32 in the output carry.  By default the fewest CTAs from
    one live slot a thread (``K2_THREADS`` slot pairs a CTA) up to
    ``K2_CLUSTER_MAX`` that hold the runs, else the fewest that hold the
    rest; ``ctas`` asks for a size (1 to ``K2_CLUSTER_MAX``, at most one
    CTA a slot pair).
    """
    npairs = (nslot + 1) // 2
    rows = (5 if ls3 else 3) * (an_max + bn_max)

    def smem(P, runs):
        pc = -(-npairs // P)
        n2 = 2 * pc + 2
        return 4 * K2_SPAN * pc + 21 * n2 + RUN_BYTES[runs] * rows * n2

    lo = max(1, -(-npairs // K2_THREADS))
    sizes = ([ctas] if ctas is not None
             else range(min(lo, K2_CLUSTER_MAX), K2_CLUSTER_MAX + 1))
    sizes = [P for P in sizes if 1 <= P <= min(K2_CLUSTER_MAX, npairs)]
    for runs in ("shared16" if la_max + lb_max < 32767 else "shared32",
                 "device"):
        for P in sizes:
            if smem(P, runs) <= SMEM_MAX:
                pc = -(-npairs // P)
                return {"ctas": P, "pairs_per_cta": pc,
                        "slots_per_cta": 2 * pc,
                        "threads": min(max(-(-pc // 32) * 32, 32),
                                       K2_THREADS),
                        "runs": runs, "smem_bytes": smem(P, runs)}
    return None


def wavefront_variant(an_max: int, bn_max: int, nslot: int, la_max: int,
                      lb_max: int, ls3: bool, variant: str | None = None,
                      ctas: int | None = None) -> tuple[str, int]:
    """K2's variant for a launch and its bytes of shared memory (a CTA's,
    for the cluster variant).

    "shared" keeps the gap runs (3 lanes, 5 with ls3, of nslot + 2 slots
    a member) as int16 in shared memory beside the lane values (21 bytes
    a slot) and the profile scores of the next ``K2_SPAN`` steps (f32, a
    pair of slots each); "global" keeps the runs as int32 in device
    memory; "cluster" spreads the slots over a thread-block cluster
    (``cluster_shape``); "wide" keeps the lane values and the span in
    device memory too, and no shared memory, on one block.  Shared needs
    the runs to fit in int16 (a run is at most la + lb long) and the
    block's bytes to fit in ``SMEM_MAX``, global its lane values and
    span, cluster a CTA's slice of them.  By default the first that fits
    of shared, global, cluster, wide; a ``variant`` asked for that does
    not fit raises.  ``an_max``/``bn_max`` are the largest real member
    counts of the batch (``member_counts``); ``ctas`` asks for the
    cluster variant's size.
    """
    vals = 21 * nslot + 4 * K2_SPAN * ((nslot + 1) // 2)
    runs = 2 * (5 if ls3 else 3) * (an_max + bn_max) * (nslot + 2)
    shape = cluster_shape(an_max, bn_max, nslot, la_max, lb_max, ls3, ctas)
    fits = {"shared": la_max + lb_max < 32767 and vals + runs <= SMEM_MAX,
            "global": vals <= SMEM_MAX, "cluster": shape is not None,
            "wide": True}
    smem = {"shared": vals + runs, "global": vals,
            "cluster": shape["smem_bytes"] if shape else None, "wide": 0}
    if variant is None:
        variant = next(v for v in ("shared", "global", "cluster", "wide")
                       if fits[v])
    if variant not in fits:
        raise ValueError(f"wavefront_variant: unknown variant {variant!r}")
    if not fits[variant]:
        raise ValueError(f"wavefront_variant: the {variant} variant does "
                         f"not take {an_max} + {bn_max} members at {nslot} "
                         f"slots ({smem[variant]} bytes of shared memory "
                         f"of {SMEM_MAX}, lengths {la_max} + {lb_max}"
                         + (f", {ctas} CTAs" if ctas is not None else "")
                         + ")")
    return variant, smem[variant]


def wavefront_plan(ins: dict, *, nslot: int, ls3: bool = False,
                   variant: str | None = None,
                   ctas: int | None = None) -> dict:
    """What K2 walks for a batch: per-pair real member counts, their
    largest, real and padded member pairs, and the variant (by size,
    or the one asked for); for the cluster variant also its CTAs a
    cluster, slot pairs and slots a CTA, threads a CTA; and where the
    runs live (``cluster_shape``; the shared variant "shared16", the
    global and wide variants "device")."""
    ca, cb = member_counts(ins["wa"]), member_counts(ins["wb"])
    host = trace.d2h(torch.stack([ca, cb])).long()
    an_max, bn_max = int(host[0].max()), int(host[1].max())
    la_max, lb_max = ins["CA"].shape[1], ins["CB"].shape[1]
    variant, smem = wavefront_variant(an_max, bn_max, nslot, la_max, lb_max,
                                      ls3, variant, ctas)
    shape = (cluster_shape(an_max, bn_max, nslot, la_max, lb_max, ls3, ctas)
             if variant == "cluster" else None)
    return {"an_b": ca, "bn_b": cb, "an_max": an_max, "bn_max": bn_max,
            "variant": variant, "smem_bytes": smem,
            "ctas": shape["ctas"] if shape else 1,
            "pairs_per_cta": shape["pairs_per_cta"] if shape else None,
            "slots_per_cta": shape["slots_per_cta"] if shape else nslot,
            "runs": (shape["runs"] if shape else
                     "shared16" if variant == "shared" else "device"),
            "real_pairs": (host[0] * host[1]).tolist(),
            "padded_pairs": ins["wa"].shape[1] * ins["wb"].shape[1]}


def cluster_slices(nslot: int, ctas: int) -> list[tuple[int, int]]:
    """The slots [s0, s1) CTA r of the cluster variant owns, as the
    kernel cuts them (whole slot pairs)."""
    npairs = (nslot + 1) // 2
    return [(2 * (r * npairs // ctas),
             min(2 * ((r + 1) * npairs // ctas), nslot))
            for r in range(ctas)]


def kernel_operands(ins: dict) -> tuple:
    """K2's operands made from the stacked inputs: the member factors
    pre-weighted (f32 products, as the plain version forms them) and
    widened to f64, (B, members, 4, L + 1) with the column fastest (w *
    na, w * gd, w * pg and na itself, the gap flag); the channel stacks
    as f64 (B, C, L)."""
    def weighted(w, cols):
        x = [(w[:, None, :] * ins[c]).double() for c in cols]
        x.append(ins[cols[0]].double())
        return torch.stack(x, 1).permute(0, 3, 1, 2).contiguous()

    XA = weighted(ins["wa"], ("na_a", "gda", "pga"))
    YB = weighted(ins["wb"], ("na_b", "gdb", "pgb"))
    CA, CB = (ins[k].double().transpose(1, 2).contiguous()
              for k in ("CA", "CB"))
    return XA, YB, CA, CB


_K2_VARIANTS = {"global": 0, "shared": 1, "wide": 2, "cluster": 3}


def group_wavefront(ins: dict, *, nslot: int, nsteps: int,
                    ls3: bool = False, d0: int = 0,
                    carry: Carry | None = None, variant: str | None = None,
                    ctas: int | None = None):
    """Banded group wavefront over a batch (kernel K2).

    ``ins`` holds the stacked inputs of ``stack_inputs``.  Runs steps d0
    to d0 + nsteps - 1 from ``carry`` (None: the DP corner).  Returns
    score (B,) f32, dirs and opens (B, nsteps, nslot) int8 (row i: step
    d0 + i) and the final state (``Carry``).  CPU tensors take the plain
    version; CUDA tensors launch the kernel on the operands of
    ``kernel_operands``, walking each pair's real members only, in the
    variant ``wavefront_plan`` picks by size (or ``variant``, and for
    the cluster variant ``ctas``).
    """
    with trace.span("prrn.group.k2"):
        if ins["CA"].device.type == "cpu":
            return group_wavefront_ref(ins, nslot=nslot, nsteps=nsteps,
                                       ls3=ls3, d0=d0, carry=carry)
        return _launch_wavefront(ins, nslot, nsteps, ls3, d0, carry, variant,
                                 ctas)


def _launch_wavefront(ins, nslot, nsteps, ls3, d0, carry, variant, ctas):
    """``group_wavefront`` on a CUDA device: K2's plan, operands and
    launch."""
    dev = ins["CA"].device
    if dev.type != "cuda":
        raise ValueError(f"group_wavefront: unsupported device {dev}")
    if d0 < 0:
        raise ValueError(f"group_wavefront: step offset {d0}")
    Bn, la_max, C = ins["CA"].shape
    lb_max = ins["CB"].shape[1]
    an = ins["wa"].shape[1]
    bn = ins["wb"].shape[1]
    shapes = {"CA": (Bn, la_max, C), "CB": (Bn, lb_max, C),
              "ea0": (Bn, la_max), "eb0": (Bn, lb_max),
              "na_a": (Bn, la_max + 1, an), "gda": (Bn, la_max + 1, an),
              "pga": (Bn, la_max + 1, an), "na_b": (Bn, lb_max + 1, bn),
              "gdb": (Bn, lb_max + 1, bn), "pgb": (Bn, lb_max + 1, bn),
              "cfa": (Bn, la_max + 1), "efa": (Bn, la_max + 1),
              "cfb": (Bn, lb_max + 1), "efb": (Bn, lb_max + 1),
              "wa": (Bn, an), "wb": (Bn, bn)}
    for k in _FIELDS:
        _build.require(ins[k], k, torch.float32, shapes[k], dev)
    plan = wavefront_plan(ins, nslot=nslot, ls3=ls3, variant=variant,
                          ctas=ctas)
    iprm = torch.stack([ins[k] for k in _IFIELDS]
                       + [plan["an_b"], plan["bn_b"]], 1).contiguous()
    fprm = torch.stack([ins[k] for k in _FFIELDS], 1).contiguous()
    _build.require(iprm, "iprm", torch.int32, (Bn, 7), dev)
    _build.require(fprm, "fprm", torch.float32, (Bn, 4), dev)
    XA, YB, CA, CB = kernel_operands(ins)
    score = torch.empty(Bn, dtype=torch.float32, device=dev)
    dirs = torch.empty((Bn, nsteps, nslot), dtype=torch.int8, device=dev)
    opens = torch.empty((Bn, nsteps, nslot), dtype=torch.int8, device=dev)
    rows = (5 if ls3 else 3) * (plan["an_max"] + plan["bn_max"])
    out = Carry(torch.empty((Bn, 5, nslot), dtype=torch.float32, device=dev),
                torch.empty((Bn, nslot), dtype=torch.int8, device=dev),
                torch.empty((Bn, rows, nslot + 2), dtype=torch.int32,
                            device=dev))
    if carry is not None:
        for name, t in zip(Carry._fields, carry):
            _build.require(t, f"carry.{name}", getattr(out, name).dtype,
                           getattr(out, name).shape, dev)
    wide = plan["variant"] == "wide"
    span = torch.empty((Bn, K2_SPAN * ((nslot + 1) // 2)) if wide else 1,
                       dtype=torch.float32, device=dev)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.group_wavefront_launch(
        CA.data_ptr(), CB.data_ptr(), XA.data_ptr(), YB.data_ptr(),
        *(ins[k].data_ptr() for k in ("ea0", "eb0", "cfa", "efa", "cfb",
                                      "efb")),
        iprm.data_ptr(), fprm.data_ptr(),
        score.data_ptr(), dirs.data_ptr(), opens.data_ptr(),
        *((None,) * 3 if carry is None else (t.data_ptr() for t in carry)),
        *(t.data_ptr() for t in out), span.data_ptr(),
        Bn, C, an, bn, plan["an_max"], plan["bn_max"], la_max, lb_max,
        nslot, nsteps, d0, int(ls3), _K2_VARIANTS[plan["variant"]],
        plan["ctas"], RUN_BYTES[plan["runs"]], stream)
    _build.check(err, "group_wavefront_launch")
    _build.LAUNCHES["group_wavefront"] += 1
    trace.COUNTS["k2.steps"] += nsteps
    return score, dirs, opens, out


def group_wavefront_attrs(ls3: bool, variant: str,
                          runs: str = "shared16") -> dict:
    """Registers a thread and local (spilled) bytes of one of K2's
    instantiations, as the card's loader reports them (the cluster
    variant's with its runs where ``runs`` says, as ``cluster_shape``
    names it)."""
    out = (ctypes.c_int * 2)()
    nbytes = (RUN_BYTES[runs] if variant == "cluster"
              else 2 if variant == "shared" else 0)
    _build.check(_build.load().group_wavefront_attrs(
        int(ls3), _K2_VARIANTS[variant], nbytes,
        ctypes.addressof(out)), "group_wavefront_attrs")
    return {"registers": out[0], "local_bytes": out[1]}


def _walk_ref(dn: np.ndarray, on: np.ndarray, m: int, n: int, lane: int,
              d_lo: int, lw: int, floor: int | None, max_iters: int):
    """The lane machine of ``_traceback_device`` on one pair's planes,
    row i holding step d_lo + i, from (m, n, lane) while m + n stays at
    or above ``floor`` (None: no floor).  Returns (m, n, lane, moves end
    to start, count)."""
    nsteps, nslot = dn.shape
    moves = np.full(max_iters, -1, np.int8)
    cnt = it = 0
    off = -(lw - 1)
    # lane codes: 0=H 1=G 2=G2 3=F 4=F2
    while ((m > 0 or n > 0) and (floor is None or m + n >= floor)
           and it < 3 * max_iters):
        d = m + n
        if d > 0 and 0 <= d - d_lo < nsteps:
            # the device walk's dynamic index: negative slots wrap, then
            # clamp
            slot = off + n - m
            slot = min(max(slot + nslot if slot < 0 else slot, 0), nslot - 1)
            src, op = int(dn[d - d_lo, slot]), int(on[d - d_lo, slot])
        else:
            src, op = -1, 0
        if lane == 0:
            if src == DIAG:
                emit, m, n = DIAG, m - 1, n - 1
            else:
                emit = -1
                lane = {VERT: 1, VERT2: 2, HORI2: 4}.get(src, 3)
        elif lane in (1, 2):
            emit, m = VERT, m - 1
            if op & (1 if lane == 1 else 4) or n == 0:
                lane = 0
        else:
            emit, n = HORI, n - 1
            if op & (2 if lane == 3 else 8) or m == 0:
                lane = 0
        moves[min(cnt, max_iters - 1)] = emit
        cnt += emit >= 0
        it += 1
    return m, n, lane, moves, min(cnt, max_iters)


def _host_ints(x, Bn: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(torch.as_tensor(x).cpu(), np.int64),
                           (Bn,))


def traceback_ref(dirs: torch.Tensor, opens: torch.Tensor, La, Lb, lw,
                  *, max_iters: int):
    """Plain version of kernel K3: the lane machine of
    ``_traceback_device`` walked on the host for each pair.  Returns
    moves (B, max_iters) int8, recorded end to start, and counts (B,)."""
    dn = dirs.cpu().numpy()
    on = opens.cpu().numpy()
    Bn = dn.shape[0]
    La, Lb, lw = (_host_ints(x, Bn) for x in (La, Lb, lw))
    walks = [_walk_ref(dn[b], on[b], int(La[b]), int(Lb[b]), 0, 0,
                       int(lw[b]), None, max_iters) for b in range(Bn)]
    return (torch.as_tensor(np.stack([w[3] for w in walks]),
                            device=dirs.device),
            torch.as_tensor(np.array([w[4] for w in walks], np.int32),
                            device=dirs.device))


def traceback_range_ref(dirs: torch.Tensor, opens: torch.Tensor, m0, n0,
                        lane0, d_lo, lw, *, max_iters: int):
    """Plain version of K3's range walk (``_traceback_device_range``):
    from (m0, n0, lane0) over planes whose row i holds step d_lo + i,
    until the walk reaches the corner or leaves the steps from
    max(d_lo, 1) up.  All arguments but the planes (B,) ints.  Returns
    m, n, lane (B,) int32 where the walk stopped, moves (B, max_iters)
    int8 end to start and counts (B,) int32."""
    dn = dirs.cpu().numpy()
    on = opens.cpu().numpy()
    Bn = dn.shape[0]
    m0, n0, lane0, d_lo, lw = (_host_ints(x, Bn)
                               for x in (m0, n0, lane0, d_lo, lw))
    walks = [_walk_ref(dn[b], on[b], int(m0[b]), int(n0[b]), int(lane0[b]),
                       int(d_lo[b]), int(lw[b]), max(int(d_lo[b]), 1),
                       max_iters) for b in range(Bn)]
    ints = [torch.as_tensor(np.array([w[k] for w in walks], np.int32),
                            device=dirs.device) for k in (0, 1, 2, 4)]
    return (*ints[:3], torch.as_tensor(np.stack([w[3] for w in walks]),
                                       device=dirs.device), ints[3])


# K3's staged variant: a tile holds at most this many bytes of a plane
# (fewer rows to wait for before the walk starts, against fewer tile
# crossings), and at least K3_MIN_ROWS rows, or the window variant walks
K3_TILE_BYTES = 32768
K3_MIN_ROWS = 8
# shared memory ahead of K3's tile buffers (its mbarriers and flags,
# padded)
K3_HEAD = 128
# K3's window variant: rows a tile, stages in flight (at most 4), and a
# row's window, 2 * rows + 32 slots rounded out to 16 bytes
K3_WINDOW_ROWS = 64
K3_WINDOW_STAGES = 3
K3_MAX_STAGES = 4


def _k3_cap(rows: int, nslot: int) -> int:
    """Bytes of one of K3's tile buffers for ``rows`` rows: a window
    rounded out to 16 bytes at both ends, in a multiple of 128."""
    return -(-(rows * nslot + 32) // 128) * 128


def traceback_plan(nsteps: int, nslot: int, max_iters: int, *,
                   variant: str | None = None,
                   tile_rows: int | None = None,
                   width: int | None = None,
                   stages: int | None = None) -> dict:
    """K3's variant for planes of (nsteps, nslot) and its tiles.

    "staged" walks one pair a block with tiles of ``tile_rows`` band rows
    of both planes double-buffered in shared memory (four buffers of
    ``width`` bytes) beside the ``max_iters`` moves; "window" walks one
    pair a block of two warps with tiles of ``tile_rows`` rows of a
    window of ``width`` bytes a plane around the walk's slot, ``stages``
    tiles in flight, and writes the moves to device memory as it goes;
    "global" walks the planes in device memory, one thread a pair (the
    first design, only when asked for).  By default a staged tile holds
    ``K3_TILE_BYTES`` of a plane (at least ``K3_MIN_ROWS`` rows, at most
    the plane's rows and what ``SMEM_MAX`` holds), and the window variant
    takes the bands where ``K3_MIN_ROWS`` full rows do not fit
    (``K3_WINDOW_ROWS`` rows, ``K3_WINDOW_STAGES`` stages, a window of
    2 * rows + 32 slots), whatever the band's width or the walk's length.
    A variant or tile asked for that the kernel cannot take raises.
    """
    if nsteps < 1 or nslot < 1 or max_iters < 1:
        raise ValueError(f"traceback_plan: empty planes ({nsteps}, {nslot}) "
                         f"or max_iters {max_iters}")
    if nsteps * nslot >= 2 ** 31:
        raise ValueError(f"traceback_plan: planes of {nsteps} x {nslot} "
                         f"bytes a pair")
    room = (SMEM_MAX - K3_HEAD - max_iters) // 4 // 128 * 128
    fit = max((room - 32) // nslot, 0)
    rows = max(nsteps - 1, 1)
    if variant is None:
        variant = "staged" if fit >= min(K3_MIN_ROWS, rows) else "window"
    if variant != "window" and (width is not None or stages is not None):
        raise ValueError(f"traceback_plan: the {variant} variant has no "
                         f"window or stages")
    if variant == "global":
        if tile_rows is not None:
            raise ValueError("traceback_plan: the global variant has no tiles")
        return {"variant": "global", "tile_rows": 0, "width": 0,
                "smem_bytes": 0}
    if variant == "window":
        if tile_rows is None:
            tile_rows = min(K3_WINDOW_ROWS, rows)
        if width is None:
            width = -(-(2 * tile_rows + 32) // 16) * 16
        if stages is None:
            stages = K3_WINDOW_STAGES
        if tile_rows < 1 or width < 16 or width % 16:
            raise ValueError(f"traceback_plan: a window of {tile_rows} rows "
                             f"of {width} bytes")
        if not 2 <= stages <= K3_MAX_STAGES:
            raise ValueError(f"traceback_plan: {stages} stages")
        smem = K3_HEAD + 2 * stages * tile_rows * width
        if smem > SMEM_MAX:
            raise ValueError(f"traceback_plan: {stages} stages of "
                             f"{tile_rows} rows of {width} bytes do not fit "
                             f"in {SMEM_MAX} bytes of shared memory")
        return {"variant": "window", "tile_rows": tile_rows, "width": width,
                "stages": stages, "smem_bytes": smem}
    if variant != "staged":
        raise ValueError(f"traceback_plan: unknown variant {variant!r}")
    if tile_rows is None:
        tile_rows = min(fit, rows, max(K3_MIN_ROWS, K3_TILE_BYTES // nslot))
    if not 1 <= tile_rows <= fit:
        raise ValueError(f"traceback_plan: {tile_rows} rows of {nslot} "
                         f"slots with {max_iters} moves do not fit in "
                         f"{SMEM_MAX} bytes of shared memory ({fit} rows do)")
    width = _k3_cap(tile_rows, nslot)
    return {"variant": "staged", "tile_rows": tile_rows, "width": width,
            "smem_bytes": K3_HEAD + 4 * width + max_iters}


_K3_VARIANTS = {"global": 0, "staged": 1, "window": 2}


def _launch_walk(dirs, opens, starts: dict, ends, *, max_iters: int,
                 plan: dict | None, name: str):
    """K3 on CUDA planes: ``starts`` the (B,) int32 tensors m0, n0 and,
    for the range walk, lane0 and d_lo; ``ends`` the (B,) int32 tensors
    the range walk leaves m, n, lane in (None for the walk from the
    end).  Returns moves and counts."""
    dev = dirs.device
    Bn, nsteps, nslot = dirs.shape
    _build.require(dirs, "dirs", torch.int8, (Bn, nsteps, nslot), dev)
    _build.require(opens, "opens", torch.int8, (Bn, nsteps, nslot), dev)
    for key, t in starts.items():
        _build.require(t, key, torch.int32, (Bn,), dev)
    if plan is None:
        plan = traceback_plan(nsteps, nslot, max_iters)
    if plan["variant"] == "window" and (dirs.data_ptr() % 16
                                        or opens.data_ptr() % 16):
        raise ValueError("traceback: the window variant takes planes on "
                         "16-byte boundaries")
    moves = torch.empty((Bn, max_iters), dtype=torch.int8, device=dev)
    cnts = torch.empty(Bn, dtype=torch.int32, device=dev)
    if Bn == 0:
        return moves, cnts
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    err = lib.traceback_launch(
        dirs.data_ptr(), opens.data_ptr(),
        *(ptr(starts.get(k)) for k in ("m0", "n0", "lane0", "d_lo", "lw")),
        moves.data_ptr(), cnts.data_ptr(),
        *((None,) * 3 if ends is None else (t.data_ptr() for t in ends)),
        Bn, nsteps, nslot, max_iters, int(ends is not None),
        _K3_VARIANTS[plan["variant"]], plan["tile_rows"], plan["width"],
        plan.get("stages", 0), plan["smem_bytes"], stream)
    _build.check(err, "traceback_launch")
    _build.LAUNCHES[name] += 1
    return moves, cnts


def traceback(dirs: torch.Tensor, opens: torch.Tensor, La: torch.Tensor,
              Lb: torch.Tensor, lw: torch.Tensor, *, max_iters: int,
              plan: dict | None = None):
    """Walk the direction planes of a batch from (La, Lb) (kernel K3).

    dirs/opens (B, nsteps, nslot) int8; La, Lb, lw (B,) int32.  Returns
    moves (B, max_iters) int8 end to start and counts (B,) int32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel in the
    variant ``plan`` gives (default: ``traceback_plan`` by size).
    """
    dev = dirs.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"traceback: unsupported device {dev}")
    with trace.span("prrn.group.k3"):
        if dev.type == "cpu":
            return traceback_ref(dirs, opens, La, Lb, lw,
                                 max_iters=max_iters)
        return _launch_walk(dirs, opens, {"m0": La, "n0": Lb, "lw": lw},
                            None, max_iters=max_iters, plan=plan,
                            name="traceback")


def traceback_range(dirs: torch.Tensor, opens: torch.Tensor, m0, n0, lane0,
                    d_lo, lw, *, max_iters: int, plan: dict | None = None):
    """K3's range walk over one chunk's planes (the backward pass of
    ``group_align_linear``): from (m0, n0, lane0), row i of the planes
    holding step d_lo + i, until the walk reaches the corner or leaves
    the steps from max(d_lo, 1) up.  m0, n0, lane0, d_lo, lw (B,) int32.
    Returns m, n, lane (B,) int32 where it stopped, moves (B, max_iters)
    int8 end to start and counts (B,) int32.  CPU tensors take the plain
    version; CUDA tensors launch the kernel as ``traceback`` does."""
    dev = dirs.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"traceback_range: unsupported device {dev}")
    with trace.span("prrn.group.k3"):
        if dev.type == "cpu":
            return traceback_range_ref(dirs, opens, m0, n0, lane0, d_lo, lw,
                                       max_iters=max_iters)
        ends = tuple(torch.empty(dirs.shape[0], dtype=torch.int32,
                                 device=dev) for _ in range(3))
        moves, cnts = _launch_walk(
            dirs, opens, {"m0": m0, "n0": n0, "lane0": lane0, "d_lo": d_lo,
                          "lw": lw}, ends, max_iters=max_iters, plan=plan,
            name="traceback_range")
        return (*ends, moves, cnts)


def traceback_attrs(variant: str) -> dict:
    """Registers a thread and local (spilled) bytes of one of K3's
    variants, as the card's loader reports them."""
    out = (ctypes.c_int * 2)()
    _build.check(_build.load().traceback_attrs(
        _K3_VARIANTS[variant], ctypes.addressof(out)), "traceback_attrs")
    return {"registers": out[0], "local_bytes": out[1]}


def _skls(moves: torch.Tensor, cnts: torch.Tensor, las, lbs) -> list:
    moves = trace.d2h(moves).numpy()
    cnts = trace.d2h(cnts).numpy()
    trace.COUNTS["k3.moves"] += int(cnts.sum())
    return [_moves_to_skl(moves[k, :cnts[k]][::-1], int(las[k]),
                          int(lbs[k])) for k in range(moves.shape[0])]


def _pack_inputs(A: Msa, B: Msa, mtx, u, v, wdw, pa, pb, la_max, lb_max,
                 spb: float = 0.0, scale: float = 1.0, ls: int = 1,
                 u1: float = 0.6, k1: int = 7, uniform: bool = True) -> dict:
    """One pair's wavefront inputs (channel stacks, not the score image:
    the image is built next to the DP).  ``uniform``: collapse a gap-free
    side to one member (``uniform_side``), as ``group_align`` does and
    ``group_align_linear`` does not."""
    with trace.span("prrn.group.pack"):
        CA, CB, ea0, eb0 = _pack_profiles(A, B, mtx, la_max, lb_max,
                                          spb=spb, scale=scale)
        cols = _pack_cols(A, B, pa, pb, la_max, lb_max,
                          ua=uniform and uniform_side(A),
                          ub=uniform and uniform_side(B))
    ls3 = ls >= 3
    item = dict(zip(_FIELDS, (CA, CB, ea0, eb0, *cols)))
    item.update(la=A.length, lb=B.length, lw=wdw.lw, up=wdw.up,
                k1=k1 if ls3 else 10 ** 9, u=u, gop_scale=-scale * v,
                v2divv1=(v + (u - u1) * k1) / v if ls3 else 0.0,
                u2divu1=(u1 / u) if ls3 else 0.0)
    return item


def _align_items(items, nslot, nsteps, la_max, lb_max, ls3, device):
    """Wavefront (K2) plus traceback (K3) for packed pairs; returns the
    scores (numpy) and the SKLs."""
    ins = stack_inputs(items, device)
    score, dirs, opens, _ = group_wavefront(ins, nslot=nslot, nsteps=nsteps,
                                            ls3=ls3)
    max_iters = 2 * (la_max + lb_max) + 4
    moves, cnts = traceback(dirs, opens, ins["la"], ins["lb"], ins["lw"],
                            max_iters=max_iters)
    las = [it["la"] for it in items]
    lbs = [it["lb"] for it in items]
    with trace.span("prrn.group.fetch"):
        return trace.d2h(score).numpy(), _skls(moves, cnts, las, lbs)


def group_align(A: Msa, B: Msa, mtx: np.ndarray, u: float, v: float,
                wdw: Window | None = None, scale: float = 1.0,
                pads: tuple[int, int] | None = None, spb: float = 0.0,
                ls: int = 1, u1: float = 0.6, k1: int = 7, *,
                device, _retried: bool = False):
    """Align two prepared groups on ``device``; returns (score, skl).

    ``pads`` = (member_pad, length_pad) pads member counts (zero-weight
    phantom members) and lengths to fixed buckets, as in the JAX
    package.  A path that escapes the stripe or a score that never left
    the sentinel means the band was too narrow; like the reference's
    corner-miss recovery (maln2.cc:1944-1952, sh := -100) the alignment
    is retried once with a full-width band.
    """
    La, Lb = A.length, B.length
    an = effective_members(A)
    bn = effective_members(B)
    if wdw is None:
        wdw = stripe(La, Lb, -60)
    lw, up = wdw.lw, wdw.up
    if pads is not None:
        an_pad, len_pad = pads
        an_pad = max(an_pad, an, bn)
        la_max = lb_max = _bucket(max(La, Lb, len_pad))
        nslot = _bucket(up - lw + 3, 128)
        nsteps = _bucket(La + Lb + 1, 256)
    else:
        an_pad = 0
        la_max, lb_max = _bucket(La), _bucket(Lb)
        nslot = _bucket(up - lw + 3)
        nsteps = _bucket(La + Lb + 1)
    item = _pack_inputs(A, B, mtx, u, v, wdw, max(an_pad, an),
                        max(an_pad, bn), la_max, lb_max, spb=spb,
                        scale=scale, ls=ls, u1=u1, k1=k1)
    scores, skls = _align_items([item], nslot, nsteps, la_max, lb_max,
                                ls >= 3, device)
    score, skl = float(scores[0]), skls[0]
    if not _retried and (score <= NEVSEL / 2 or not skl_in_band(skl, lw, up)):
        wide = stripe(La, Lb, -100)
        return group_align(A, B, mtx, u, v, wdw=wide, scale=scale,
                           pads=pads, spb=spb, ls=ls, u1=u1, k1=k1,
                           device=device, _retried=True)
    return score, skl


def group_align_batch(pairs, mtx, u: float, v: float, sh: int,
                      pads: tuple[int, int], spb: float = 0.0,
                      scale: float = 1.0, group=None, *, device):
    """Score and trace back a batch of group pairs in one launch of each
    kernel (the speculative best-of-n refinement fan-out).  ``pairs`` =
    list of (A, B) prepared Msa pairs, padded to common shapes via
    ``pads``.  Returns a list of (score, skl).

    With ``group`` every rank packs the whole batch's shapes, aligns its
    own block of the pairs on ``device`` and gathers the others', so the
    results equal the run without a group; ``LAST_BATCH_SHARD`` holds
    (rank, world, start, stop) of the last call."""
    global LAST_BATCH_SHARD
    if not pairs:
        return []
    an_pad, len_pad = pads
    an_pad = max([an_pad] + [effective_members(m)
                             for ab_ in pairs for m in ab_])
    la_max = lb_max = _bucket(max([len_pad] +
                                  [m.length for ab_ in pairs for m in ab_]))
    wdws = [stripe(A.length, B.length, sh) for A, B in pairs]
    nslot = _bucket(max(w.up - w.lw + 3 for w in wdws), 128)
    nsteps = _bucket(max(A.length + B.length + 1 for A, B in pairs), 256)
    rank, world, lo, hi = 0, 1, 0, len(pairs)
    if group is not None:
        rank, world, lo, hi = shard_block(len(pairs), group)
    LAST_BATCH_SHARD = (rank, world, lo, hi)
    pairs, wdws = pairs[lo:hi], wdws[lo:hi]
    items = [_pack_inputs(A, B, mtx, u, v, w, an_pad, an_pad, la_max,
                          lb_max, spb=spb, scale=scale)
             for (A, B), w in zip(pairs, wdws)]
    scores, skls = (_align_items(items, nslot, nsteps, la_max, lb_max,
                                 False, device) if items else ([], []))
    out = []
    for k, ((A, B), w) in enumerate(zip(pairs, wdws)):
        if float(scores[k]) <= NEVSEL / 2 or not skl_in_band(skls[k], w.lw,
                                                             w.up):
            # corner-miss recovery: redo this item alone, full width
            wide = stripe(A.length, B.length, -100)
            out.append(group_align(A, B, mtx, u, v, wdw=wide, scale=scale,
                                   pads=pads, spb=spb, device=device,
                                   _retried=True))
        else:
            out.append((float(scores[k]), skls[k]))
    return out if group is None else gather_blocks(out, group)


# steps of one K2 launch of the TPU kernel (pallas_group.DSTEP): the
# linear-space aligner's chunks are multiples of it
K2_DSTEP = 64


def group_align_linear(A: Msa, B: Msa, mtx, u: float, v: float,
                       wdw: Window | None = None, scale: float = 1.0,
                       spb: float = 0.0, ls: int = 1, u1: float = 0.6,
                       k1: int = 7, chunk: int = 2048, *, device):
    """Linear-space group alignment on ``device``: blockwise checkpoint
    and recompute traceback (the JAX package's replacement for the
    reference's Hirschberg recursion, src/fwd2b1.cc:492,1053-1078).

    The forward pass runs K2 in chunks of ``chunk`` steps and keeps each
    chunk's input carry on the device; the backward pass recomputes one
    chunk's planes at a time from its checkpoint and walks them with the
    range walk, from the last chunk down.  Device memory holds one
    chunk's planes and the checkpoints, O(chunk x nslot + nsteps / chunk x
    nslot), instead of O(nsteps x nslot).  Returns (score, skl), equal to
    ``group_align``'s.  As in the JAX package, member counts are
    ``A.many`` and ``B.many`` (no gap-free collapse) and there is no
    corner-miss retry; the JAX package's carry holds ``A.many`` rows for
    each side, so it fails where the sides' member counts differ, and so
    does this (a ValueError).
    """
    La, Lb = A.length, B.length
    an, bn = A.many, B.many
    if an != bn:
        raise ValueError(
            f"group_align_linear: {an} | {bn} members; the linear-space "
            "aligner (as the JAX package's, whose carry holds A.many rows "
            "a side) takes groups of equal member counts only")
    if wdw is None:
        wdw = stripe(La, Lb, -60)
    la_max, lb_max = _bucket(La), _bucket(Lb)
    nslot = _bucket(wdw.up - wdw.lw + 3, 128)
    nsteps_total = _bucket(La + Lb + 1, K2_DSTEP)
    chunk = max(K2_DSTEP, min(_bucket(chunk, K2_DSTEP), nsteps_total))
    nchunks = -(-nsteps_total // chunk)
    ls3 = ls >= 3
    item = _pack_inputs(A, B, mtx, u, v, wdw, an, bn, la_max, lb_max,
                        spb=spb, scale=scale, ls=ls, u1=u1, k1=k1,
                        uniform=False)
    ins = stack_inputs([item], device)
    kw = dict(nslot=nslot, nsteps=chunk, ls3=ls3)

    carry = None
    ckpts = []
    score = None
    for c in range(nchunks):
        ckpts.append(carry)
        score, _, _, carry = group_wavefront(ins, d0=c * chunk, carry=carry,
                                             **kw)
    final_score = float(score[0])

    def ints(x):
        return torch.tensor([x], dtype=torch.int32, device=ins["la"].device)

    m, n, lane, lw = ints(La), ints(Lb), ints(0), ints(wdw.lw)
    max_iters = 2 * chunk + 8
    pieces = []
    for c in reversed(range(nchunks)):
        d_lo = c * chunk
        mi, ni = int(m[0]), int(n[0])
        if mi == 0 and ni == 0:
            break
        if d_lo > mi + ni:
            continue
        _, dirs, opens, _ = group_wavefront(ins, d0=d_lo, carry=ckpts[c],
                                            **kw)
        m, n, lane, moves, cnt = traceback_range(
            dirs, opens, m, n, lane, ints(d_lo), lw, max_iters=max_iters)
        del dirs, opens
        walked = int(cnt[0])
        trace.COUNTS["k3.moves"] += walked
        pieces.append(trace.d2h(moves[0, :walked]).numpy())
    moves = np.concatenate(pieces)[::-1] if pieces else np.empty(0)
    return final_score, _moves_to_skl(moves, La, Lb)
