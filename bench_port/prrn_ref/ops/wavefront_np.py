"""K2's plain version in NumPy: ``group.wavefront_core_ref`` (PyTorch)
restated on host arrays, operation for operation, so that its results
are equal to it bit for bit (``tests/test_bench_port_reference.py``
holds it to the port's plain version).  A step of the wavefront is a
few hundred operations on small arrays; NumPy takes a fraction of the
time PyTorch's dispatch does, which is what makes the reference short
enough to run after every window.

The crg sums add their member-pair terms in order, each an exact f64
product added to the f32 accumulator in f64 and rounded to f32.  A term
that is zero leaves the accumulator as it is (every factor is
non-negative), so ``_fma_sum`` adds a slot's non-zero terms alone, in
their order: fewer passes, the same bits.  Single-affine gaps only (the
``ls3`` lanes are not restated).
"""

from __future__ import annotations

import numpy as np

from .group_np import DIAG, HORI, VERT

NEVSEL = np.float32(-1.0e30)
HALF_NEVSEL = np.float32(-1.0e30 / 2)
F32, F64, I32, I8 = np.float32, np.float64, np.int32, np.int8
ZERO32 = np.float32(0.0)
# H dir codes (group.py)
D_DEAD, D_DIAG, D_VERT, D_HORI = 0, 1, 2, 3


def _fma(a, b, c):
    """a * b + c rounded once to f32 (exact f64 product of f32 factors,
    f64 sum rounded to f32)."""
    return (a.astype(F64) * b.astype(F64) + c.astype(F64)).astype(F32)


def _fma_sum(terms: np.ndarray) -> np.ndarray:
    """Running sum over the last axis of f64 terms (exact products of
    non-negative f32 factors), each added to the f32 accumulator in f64
    and rounded to f32; a slot's zero terms are skipped."""
    nz = terms != 0
    count = int(nz.sum(-1).max()) if terms.size else 0
    if count == 0:
        return np.zeros(terms.shape[:-1], F32)
    if count < terms.shape[-1]:
        order = np.argsort(~nz, axis=-1, kind="stable")[..., :count]
        terms = np.take_along_axis(terms, order, -1)
    acc = terms[..., 0].astype(F32)
    for k in range(1, count):
        acc = (acc.astype(F64) + terms[..., k]).astype(F32)
    return acc


def profile_scores(CA: np.ndarray, CB: np.ndarray) -> np.ndarray:
    """S[b] = CA[b] @ CB[b].T, summed over the channels in order."""
    ca, cb = CA.astype(F64), CB.astype(F64)
    acc = None
    for c in range(CA.shape[2]):
        t = ca[:, :, None, c] * cb[:, None, :, c]
        acc = t.astype(F32) if acc is None else (acc.astype(F64)
                                                 + t).astype(F32)
    return acc


def _trim_members(w: np.ndarray) -> int:
    nz = np.flatnonzero((w != 0).any(0))
    return int(nz.max()) + 1 if nz.size else 1


def group_wavefront(ins: dict, *, nslot: int, nsteps: int):
    """K2 over a batch from the DP corner (``group.group_wavefront_ref``
    with ``d0 = 0`` and no carry), on the stacked inputs as host arrays.
    Returns score (B,) f32 and dirs, opens (B, nsteps, nslot) int8.

    Steps past every pair's last cell (m + n > la + lb) and slots past
    every pair's band and its halo slot (r > up + 1) hold no valid cell:
    they leave the state as it is and read -1 and 0 in the planes, so
    they are filled so and not walked."""
    S = profile_scores(ins["CA"], ins["CB"])
    B0 = ins["ea0"][:, :, None] * ins["eb0"][:, None, :]
    steps = min(nsteps, int((ins["la"] + ins["lb"]).max()) + 1)
    slots = min(nslot, int((ins["up"] - ins["lw"]).max()) + 3)
    score, dirs, opens = wavefront_core(S, B0, *(ins[k] for k in (
        "na_a", "gda", "pga", "na_b", "gdb", "pgb", "cfa", "efa", "cfb",
        "efb", "wa", "wb", "la", "lb", "lw", "up", "u", "gop_scale")),
        nslot=slots, nsteps=steps)
    Bn = S.shape[0]
    dirs_out = np.full((Bn, nsteps, nslot), -1, I8)
    opens_out = np.zeros((Bn, nsteps, nslot), I8)
    dirs_out[:, :steps, :slots] = dirs
    opens_out[:, :steps, :slots] = opens
    return score, dirs_out, opens_out


def wavefront_core(S, B0, na_a, gda, pga, na_b, gdb, pgb, cfa, efa, cfb,
                   efb, wa, wb, la, lb, lw, up, u, gop_scale, *,
                   nslot: int, nsteps: int):
    """``group.wavefront_core_ref`` without the ls3 lanes, from the
    corner: the same operations in the same order on NumPy arrays."""
    Bn, la_max, lb_max = S.shape
    an = _trim_members(wa)
    bn = _trim_members(wb)
    na_a, gda, pga = (x[:, :, :an] for x in (na_a, gda, pga))
    na_b, gdb, pgb = (x[:, :, :bn] for x in (na_b, gdb, pgb))
    wa, wb = wa[:, None, :an], wb[:, None, :bn]
    la, lb, lw, up = (np.asarray(x).astype(np.int64)[:, None]
                      for x in (la, lb, lw, up))
    u, gop_scale = (np.asarray(x).astype(F32)[:, None]
                    for x in (u, gop_scale))
    neg_u = -u
    r_all = lw - 1 + np.arange(nslot)[None, :]

    Hval = np.where(r_all == 0, ZERO32, NEVSEL).astype(F32)
    Gval = np.full((Bn, nslot), NEVSEL, F32)
    Fval = np.full((Bn, nslot), NEVSEL, F32)
    Hdir = np.where(r_all == 0, I8(D_DIAG), I8(0)).astype(I8)
    Hgla, Ggla, Fgla = (np.zeros((Bn, nslot, an), I32) for _ in range(3))
    Hglb, Gglb, Fglb = (np.zeros((Bn, nslot, bn), I32) for _ in range(3))
    agap = na_a <= 0.0
    bgap = na_b <= 0.0
    Sflat = S.reshape(Bn, -1)
    B0flat = B0.reshape(Bn, -1)
    one, zero_i = I32(1), I32(0)
    bidx = np.arange(Bn)[:, None]

    def _rows(x, idx):
        """x (B, L, K) at idx (B, R) -> (B, R, K)."""
        return x[bidx, idx]

    def lo(x, fill):
        return np.concatenate([np.full_like(x[:, :1], fill), x[:, :-1]], 1)

    def hi(x, fill):
        return np.concatenate([x[:, 1:], np.full_like(x[:, :1], fill)], 1)

    def pair_sum(x, ge, y):
        """sum_i sum_j x_i * [ge_ij] * y_j, in order (i outer, j inner)."""
        prod = (x.astype(F64)[:, :, :, None] * ge
                * y.astype(F64)[:, :, None, :]).reshape(Bn, nslot, -1)
        return _fma_sum(prod)

    dirs_out = np.empty((Bn, nsteps, nslot), I8)
    opens_out = np.empty((Bn, nsteps, nslot), I8)

    for d in range(nsteps):
        m_vec = (d - r_all) >> 1
        n_vec = d - m_vec
        valid = (((d - r_all) % 2 == 0) & (m_vec >= 0) & (m_vec <= la)
                 & (n_vec >= 0) & (n_vec <= lb)
                 & (r_all >= lw) & (r_all <= up) & (d > 0))
        mc = np.clip(m_vec, 0, la_max)
        nc = np.clip(n_vec, 0, lb_max)
        is_top = m_vec == 0
        is_left = n_vec == 0
        a_gap_col = _rows(agap, mc)
        b_gap_col = _rows(bgap, nc)
        cell = (np.clip(m_vec - 1, 0, la_max - 1) * lb_max
                + np.clip(n_vec - 1, 0, lb_max - 1))
        s_cell = Sflat[bidx, cell]
        b0_cell = np.where((m_vec >= 1) & (n_vec >= 1), B0flat[bidx, cell],
                           ZERO32)
        ppa = cfa[bidx, mc] * efb[bidx, nc]
        ppb = cfb[bidx, nc] * efa[bidx, mc]
        xa_na = wa * _rows(na_a, mc)
        xa_gd = wa * _rows(gda, mc)
        xa_pg = wa * _rows(pga, mc)
        yb_na = wb * _rows(na_b, nc)
        yb_gd = wb * _rows(gdb, nc)
        yb_pg = wb * _rows(pgb, nc)

        def crg(gla, glb, d3):
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

        # diagonal candidate
        d_val = _fma(crg(Hgla, Hglb, 0), gop_scale, Hval + s_cell)
        d_gla = np.where(a_gap_col, Hgla + one, zero_i)
        d_glb = np.where(b_gap_col, Hglb + one, zero_i)

        # vertical lane
        rgop_v = crg(Hgla_hi, Hglb_hi, 1)
        ext_gv = _fma(crg(Ggla_hi, Gglb_hi, 1), gop_scale, Gval_hi)
        open_gv = _fma(rgop_v, gop_scale, Hval_hi)
        open_v = (Hdir_hi != D_VERT) & (open_gv > ext_gv)
        pua = ppa * neg_u
        gv = np.where(open_v, open_gv, ext_gv) + pua
        g_gla = np.where(a_gap_col, np.where(
            open_v[:, :, None], Hgla_hi, Ggla_hi) + one, zero_i)
        g_glb = np.where(open_v[:, :, None], Hglb_hi, Gglb_hi) + one
        vert_ok = m_vec >= 2
        gv = np.where(vert_ok, gv, NEVSEL)

        # horizontal lane
        rgop_h = crg(Hgla_lo, Hglb_lo, -1)
        ext_fv = _fma(crg(Fgla_lo, Fglb_lo, -1), gop_scale, Fval_lo)
        open_fv = _fma(rgop_h, gop_scale, Hval_lo)
        open_h = (Hdir_lo != D_HORI) & (open_fv > ext_fv)
        pub = ppb * neg_u
        fv = np.where(open_h, open_fv, ext_fv) + pub
        f_gla = np.where(open_h[:, :, None], Hgla_lo, Fgla_lo) + one
        f_glb = np.where(b_gap_col, np.where(
            open_h[:, :, None], Hglb_lo, Fglb_lo) + one, zero_i)
        hori_ok = n_vec >= 2
        fv = np.where(hori_ok, fv, NEVSEL)

        # boundary chains
        top_val = open_fv + pub
        left_val = open_gv + pua

        # select (lane order: g, f ties)
        mx_val = gv
        t = fv >= mx_val
        mx_val = np.where(t, fv, mx_val)
        mx_lane = np.where(t, I8(HORI), I8(VERT)).astype(I8)
        has_b0 = (b0_cell != 0.0) & (mx_val > HALF_NEVSEL)
        mx_val = np.where(has_b0, mx_val + b0_cell, mx_val)
        gv = np.where(has_b0 & (mx_lane == VERT), gv + b0_cell, gv)
        fv = np.where(has_b0 & (mx_lane == HORI), fv + b0_cell, fv)
        nondiag = mx_val > d_val
        is_vlane = mx_lane == VERT
        h_val = np.where(nondiag, mx_val, d_val)
        h_dir = np.where(nondiag, np.where(is_vlane, I8(D_VERT), I8(D_HORI)),
                         I8(D_DIAG)).astype(I8)
        h_src = np.where(nondiag, mx_lane, I8(DIAG)).astype(I8)

        lane = mx_lane[:, :, None]
        mx_gla = np.where(lane == VERT, g_gla, f_gla)
        mx_glb = np.where(lane == VERT, g_glb, f_glb)
        nd3 = nondiag[:, :, None]
        h_gla = np.where(nd3, mx_gla, d_gla)
        h_glb = np.where(nd3, mx_glb, d_glb)

        # overlay boundary chains
        h_val = np.where(is_top, top_val, np.where(is_left, left_val, h_val))
        h_dir = np.where(is_top, I8(D_HORI),
                         np.where(is_left, I8(D_VERT), h_dir)).astype(I8)
        h_src = np.where(is_top, I8(HORI),
                         np.where(is_left, I8(VERT), h_src)).astype(I8)
        top3, left3 = is_top[:, :, None], is_left[:, :, None]
        h_gla = np.where(top3, Hgla_lo + one, np.where(
            left3, np.where(a_gap_col, Hgla_hi + one, zero_i), h_gla))
        h_glb = np.where(top3, np.where(b_gap_col, Hglb_lo + one, zero_i),
                         np.where(left3, Hglb_hi + one, h_glb))

        # masked writeback
        vm = valid
        vm3 = vm[:, :, None]
        inner = vm & ~is_top & ~is_left
        Hval = np.where(vm, h_val, Hval)
        Hdir = np.where(vm, h_dir, Hdir)
        Hgla = np.where(vm3, h_gla, Hgla)
        Hglb = np.where(vm3, h_glb, Hglb)
        Gval = np.where(vm, np.where(inner, gv, NEVSEL), Gval)
        Ggla = np.where(vm3, g_gla, Ggla)
        Gglb = np.where(vm3, g_glb, Gglb)
        Fval = np.where(vm, np.where(inner, fv, NEVSEL), Fval)
        Fgla = np.where(vm3, f_gla, Fgla)
        Fglb = np.where(vm3, f_glb, Fglb)
        dirs_out[:, d] = np.where(vm, h_src, I8(-1))
        opens_out[:, d] = ((vm & open_v).astype(I8)
                           + I8(2) * (vm & open_h).astype(I8))

    score = np.where(r_all == lb - la, Hval, NEVSEL).max(1)
    return score, dirs_out, opens_out
