// Kernel K2: banded group-to-group profile DP, anti-diagonal wavefront.
//
// Replaces prrn_aln_tpu/ops/pallas_group.py::_kernel (the TPU kernel
// launched by _launch_core / _launch from ops/group.py).  Its plain
// PyTorch version is ops/group.py::group_wavefront_ref, a transcription
// of prrn_aln_tpu/ops/group.py::_wavefront_core fed by the score image
// of _wavefront_from_profiles; this kernel runs the same f32 operations
// in the same order (built with -fmad=false), so its score, dirs and
// opens planes equal the plain version's bit for bit.
//
// The work: a pair takes nsteps dependent anti-diagonal steps (La + Lb +
// 1, bucketed) with one barrier each.  In a step each live slot takes the
// exact gap-open counts (crg) as six sums over its member pairs (eight
// with ls3), each a chain of f64 adds rounded to f32, and the profile
// score of its cell, a chain over the C channels.
//
// The design, for the H100:
// - Each pair walks only its real members: the wrapper passes, per pair,
//   the members up to the last non-zero weight (iprm columns 5 and 6).
//   A dropped member's terms are exact zeros, so the sums are unchanged.
// - The per-member gap-run lengths of the lanes GH, GG, GF (and GG2, GF2
//   with ls3) live in dynamic shared memory as int16 beside the lane
//   values (H, G, F, G2, F2, Hdir): one contiguous per-pair state block
//   (the "shared" variant).  Each run row has a zero slot at both ends,
//   so the neighbours of the edge slots read 0 without a branch.  Where
//   that does not fit in a block's 227 KB, or a run could pass int16, the
//   wrapper picks the "global" variant, which keeps the runs as int32 in
//   device memory (in the output carry itself).  Where even the lane
//   values and the profile-score span do not fit in one block (a band
//   past ~6,280 slots), the "cluster" variant spreads the pair's slots
//   over a thread-block cluster of up to 16 CTAs (below).  Past what one
//   cluster holds (~100,000 slots), or when asked for, the "wide" variant
//   keeps the lane values and Hdir in the output carry and the span in a
//   scratch a pair, on one block: the barrier orders the block's
//   device-memory writes before its reads as it does its shared ones.
// - A launch resumes from a carry (the state after an earlier launch's
//   last step, or the DP corner) at step d0, and leaves its own final
//   state in the output carry: the lane values and Hdir over the slots,
//   and the runs as int32 rows laid out as in the state block.  Row i of
//   the planes holds step d0 + i; the live-slot parity, the look-ahead of
//   the profile scores and the boundary tests all take d0 + i.  A run row
//   belongs to member i of A at lane * an_max + i, to member j of B at
//   lanes * an_max + lane * bn_max + j; rows past a pair's real members
//   are copied from the input carry to the output untouched.
// - The member factors come pre-weighted from the wrapper, as doubles
//   (x = wa[i] * XA[m, i] and y = wb[j] * YB[n, j], f32 products made
//   exact in f64), and the channel stacks as doubles, all through the
//   read-only path; the six (eight) chains run interleaved in one loop
//   over (i, j), each in its own fixed order (i outer, j inner).
// - The profile scores do not depend on the DP: every kSpan steps a
//   thread computes those of its own cells for the next kSpan steps as
//   kSpan interleaved chains into shared memory, where it alone reads
//   them.
// - At step d only slots of d's parity change, and they read only their
//   own slot and the two neighbours of the other parity, so all state is
//   updated in place and one barrier a step suffices; thread t takes the
//   live slot 2t + parity.
// - The cluster variant: CTA r of a pair's cluster of P owns slot pairs
//   q0 to q1 - 1 (r * npairs / P to (r + 1) * npairs / P), so its slice
//   starts on an even slot and ends on an odd one, and keeps the lane
//   values, Hdir and the span of its slice in its own shared memory, with
//   one halo slot each side; the runs too where the rows of the batch's
//   members fit, as int16 where no run can pass int16 and as int32
//   otherwise (else as int32 in the output carry, shared by the cluster,
//   as the global variant keeps them).  A slice reads across its edges
//   only through its halo: the slot before its first and the one after
//   its last.  At step d the one
//   live edge slot that a neighbour reads at step d + 1 (the slice's
//   first slot in an even step, its last in an odd one) is computed
//   first and pushed into the neighbour's halo through distributed
//   shared memory; then every thread arrives at the cluster barrier
//   (release), the interior slots are computed, a CTA barrier orders
//   them for the CTA's own threads, and the cluster barrier's wait
//   (acquire) closes the step.  A halo slot is written in the steps of
//   its parity and read in the others, and the neighbour's read of it
//   comes before the neighbour's arrive, so one cluster barrier a step
//   orders the pushes both ways.  Pairs are independent clusters: they
//   need not be resident at once.
//
// What bounds it (tools/k2_bench.py, loops cut one at a time, on an
// H100): a pair runs on one SM (the cluster variant: on P), a step at a
// time.  With many real member pairs the crg chains do: each term is an
// f64 add between two conversions, ~0.1 us a real member pair a step at
// nslot 640 (9 of a 16.8 us step at 90 pairs).  With few members
// (ce13a17's merges) a step takes ~5 us, of which cutting the profile
// scores saves 1.6 and cutting all three loops leaves 1.2 (barrier, lane
// update, plane stores).  Shared memory bounds the members the shared
// variant holds: with nslot 768 and three lanes about 70 on the two sides
// together.  The wide variant on a 20 kb DNA pair (24,064 slots, one
// member a side) takes 76.6 us a step on its one SM (chip_smoke.py,
// NVIDIA H100 80GB HBM3 at 700 W): ~23 live slots a thread, and by a
// reckoning about half of the step is the SM's f64/f32 conversions of
// the profile and crg sums (16 a clock).  The cluster variant spreads
// those over 16 SMs at one or two live slots a thread, and adds a
// cluster barrier a step (tools/k2_bench.py --profile splits a step by
// section).  Registers (sm_90a, CUDA 12.8, attrs): 128 for the global,
// shared and wide variants; with ls3 125, 96 and 128 (8 bytes spilled);
// one barrier.
//
// Sums of products (the crg sums and the profile score) run in one fixed
// order, each term added like a fused multiply-add: the product in f64
// (exact for f32 factors) is added to the f32 sum in f64 and the result
// rounded to f32.  The gap costs added to lane values are fused the same
// way where the JAX reference's are on the CPU; the plain version
// computes every one of these identically.  Built with -DK2_PROFILE, each
// thread of the cluster variant sums clock64() cycles by section of a
// step (tools/k2_bench.py --profile).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cluster_fits.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kNevsel = -1.0e30f;
constexpr int8_t D_DIAG = 1, D_VERT = 2, D_HORI = 3;
constexpr int8_t L_DIAG = 0, L_VERT = 1, L_HORI = 2, L_VERT2 = 3,
                 L_HORI2 = 4;
// gap-run lanes
constexpr int GH = 0, GG = 1, GF = 2, GG2 = 3, GF2 = 4;
constexpr int kMaxThreads = 512;
// shared memory a block can take on the H100
constexpr int kSmemMax = 232448;
// where the state block lives (ops/group.py::wavefront_variant)
constexpr int V_GLOBAL = 0, V_SHARED = 1, V_WIDE = 2, V_CLUSTER = 3;
// CTAs a cluster of the cluster variant (the non-portable most)
constexpr int kClusterMax = 16;
// components of the member factors: w * na, w * gd, w * pg, and na
// itself (the gap flag); each a row of the column index, row fastest
constexpr int FNA = 0, FGD = 1, FPG = 2, FMASK = 3, NCOMP = 4;
// steps whose profile scores a thread computes at once, ahead of the DP
constexpr int kSpan = 8;

struct Args {
  // every per-column array has the column fastest: neighbouring threads
  // take neighbouring columns, so their loads coalesce
  const double *CA, *CB;   // (B, C, la_max), (B, C, lb_max)
  const double *XA, *YB;   // (B, an, 4, la_max + 1), (B, bn, 4, lb_max + 1)
  const float *ea0, *eb0;
  const float *cfa, *efa, *cfb, *efb;
  const int32_t* iprm;   // (B, 7): la, lb, lw, up, k1, an_b, bn_b
  const float* fprm;     // (B, 4): u, gop_scale, v2divv1, u2divu1
  float* score;
  int8_t *dirs, *opens;
  // the input carry (null: the DP corner) and the output carry: lane
  // values (B, 5, nslot), Hdir (B, nslot), runs (B, run words)
  const float* vals0;
  const int8_t* hdir0;
  const int32_t* runs0;
  float* valsf;
  int8_t* hdirf;
  int32_t* runsf;
  float* span;           // wide variant: (B, kSpan, (nslot + 1) / 2)
  int C, an, bn, an_max, bn_max, la_max, lb_max, nslot, nsteps, d0;
  // the cluster variant: CTAs a cluster, and the slot pairs a CTA's
  // arrays hold (the most any CTA's slice has)
  int ctas, pc;
};

// a * b + c rounded once to f32: the f64 product of f32 factors is exact
// and the f64 sum is rounded to f32 (ops/group.py::_fma)
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

// One term of a sum: x * y (f32 values, so the f64 product is exact)
// added to the sum (an f32 value held in a double) in f64, rounded to
// f32 and held as a double again.
__device__ __forceinline__ double add_term(double acc, double x, double y) {
  return (double)(float)fma(x, y, acc);
}

__host__ __device__ constexpr int lanes_of(bool ls3) { return ls3 ? 5 : 3; }

// words of gap-run state of one pair: a row of nslot + 2 slots for each
// lane and member, the first and last slot always 0
__host__ __device__ inline size_t run_words(bool ls3, int an, int bn,
                                            int nslot) {
  return (size_t)lanes_of(ls3) * (an + bn) * (nslot + 2);
}

// bytes of dynamic shared memory: the profile scores of the next kSpan
// steps (f32), then the state block: H, G, F, G2, F2 (f32), the int16
// runs of the shared variant, Hdir (int8); none in the wide variant
__host__ __device__ inline size_t smem_bytes(bool ls3, int variant,
                                             int an_max, int bn_max,
                                             int nslot) {
  if (variant == V_WIDE) return 0;
  return (size_t)kSpan * ((nslot + 1) / 2) * sizeof(float) +
         (size_t)nslot * (5 * sizeof(float) + 1) +
         (variant == V_SHARED ? 2 * run_words(ls3, an_max, bn_max, nslot)
                              : 0);
}

// bytes of a cluster CTA's dynamic shared memory: the profile scores of
// its pc slot pairs' next kSpan steps (f32), then over its 2 pc slots
// and a halo slot each side H, G, F, G2, F2 (f32), the runs where they
// live there (words of ``run_bytes``: 2 or 4; 0: in device memory), and
// Hdir (int8)
__host__ __device__ inline size_t cluster_smem_bytes(bool ls3, int run_bytes,
                                                     int an_max, int bn_max,
                                                     int pc) {
  const size_t n2 = 2 * (size_t)pc + 2;
  return (size_t)kSpan * pc * sizeof(float) + n2 * (5 * sizeof(float) + 1) +
         (size_t)run_bytes * run_words(ls3, an_max, bn_max, 2 * pc);
}

// One pair's gap-run rows; slot k of a row is at index k + 1 - shift
// (shift: the first slot of a cluster CTA's slice, whose rows hold it
// and its halo; else 0).  The pair walks its an (bn) real members; rows
// are laid out for the batch's an_max (bn_max).
template <bool LS3, typename GR>
struct Runs {
  GR* base;
  int an, bn, arows, brows, stride, shift;
  __device__ GR* a(int lane, int i) const {
    return base + (size_t)(lane * arows + i) * stride + 1 - shift;
  }
  __device__ GR* b(int lane, int j) const {
    return base + (size_t)(lanes_of(LS3) * arows + lane * brows + j) *
                      stride + 1 - shift;
  }
};

// A pair's lane values and Hdir, indexed by slot.
struct Lanes {
  float *H, *G, *F, *G2, *F2;
  int8_t* Hdir;
};

// One pair's lengths, band, rates and operands.
struct Pair {
  const double *CA, *CB, *XA, *YB;
  const float *ea0, *eb0, *cfa, *efa, *cfb, *efb;
  int la, lb, lw, up, k1, an_b, bn_b, la_max, lb_max, C, xs, ys, nslot;
  float gop_scale, v2divv1, u2divu1, neg_u;
};

__device__ __forceinline__ Pair pair_of(const Args& args, int b) {
  const int32_t* ip = args.iprm + 7 * b;
  const int la_max = args.la_max, lb_max = args.lb_max, C = args.C;
  const int xs = la_max + 1, ys = lb_max + 1;
  Pair p;
  p.CA = args.CA + (size_t)b * la_max * C;
  p.CB = args.CB + (size_t)b * lb_max * C;
  p.XA = args.XA + (size_t)b * args.an * NCOMP * xs;
  p.YB = args.YB + (size_t)b * args.bn * NCOMP * ys;
  p.ea0 = args.ea0 + (size_t)b * la_max;
  p.eb0 = args.eb0 + (size_t)b * lb_max;
  p.cfa = args.cfa + (size_t)b * (la_max + 1);
  p.efa = args.efa + (size_t)b * (la_max + 1);
  p.cfb = args.cfb + (size_t)b * (lb_max + 1);
  p.efb = args.efb + (size_t)b * (lb_max + 1);
  p.la = ip[0];
  p.lb = ip[1];
  p.lw = ip[2];
  p.up = ip[3];
  p.k1 = ip[4];
  p.an_b = ip[5];
  p.bn_b = ip[6];
  p.la_max = la_max;
  p.lb_max = lb_max;
  p.C = C;
  p.xs = xs;
  p.ys = ys;
  p.nslot = args.nslot;
  p.neg_u = -args.fprm[4 * b + 0];
  p.gop_scale = args.fprm[4 * b + 1];
  p.v2divv1 = args.fprm[4 * b + 2];
  p.u2divu1 = args.fprm[4 * b + 3];
  return p;
}

// The crg sums of the cell at slot k (before the gop_scale factor):
// out[0] diagonal (GH at k), out[1] GH at k+1, out[2] GG at k+1,
// out[3] GH at k-1, out[4] GF at k-1, out[5] GG2 at k+1, out[6] GF2 at
// k-1.  Each is sum_i sum_j x_i [cmp] y_j in that order, i outer.
// X points at the pair's member factors, column mc; rows of xs doubles
// (Y likewise, column nc, rows of ys).
template <bool LS3, typename GR>
__device__ __forceinline__ void crg_sums(const Runs<LS3, GR>& R,
                                         const double* __restrict__ X, int xs,
                                         const double* __restrict__ Y, int ys,
                                         int k, float* out) {
  double d1 = 0., d2 = 0., v1 = 0., v2 = 0., h1 = 0., h2 = 0.;
  double v3 = 0., h3 = 0.;
  const int stride = R.stride;
  for (int i = 0; i < R.an; ++i) {
    const double* x = X + (size_t)i * NCOMP * xs;
    const double xna = __ldg(x + FNA * xs), xgd = __ldg(x + FGD * xs);
    const double xpg = __ldg(x + FPG * xs);
    const GR* ah = R.a(GH, i);
    const int a_hk = ah[k], a_hh = ah[k + 1], a_hl = ah[k - 1];
    const int a_gh = R.a(GG, i)[k + 1];
    const int a_fl = R.a(GF, i)[k - 1];
    int a_g2h = 0, a_f2l = 0;
    if (LS3) {
      a_g2h = R.a(GG2, i)[k + 1];
      a_f2l = R.a(GF2, i)[k - 1];
    }
    const GR* bh = R.b(GH, 0);
    const GR* bg = R.b(GG, 0);
    const GR* bf = R.b(GF, 0);
    const GR* bg2 = LS3 ? R.b(GG2, 0) : bh;
    const GR* bf2 = LS3 ? R.b(GF2, 0) : bh;
    const double* y = Y;
    for (int j = 0; j < R.bn; ++j, y += NCOMP * ys) {
      const double yna = __ldg(y + FNA * ys), ygd = __ldg(y + FGD * ys);
      const double ypg = __ldg(y + FPG * ys);
      const size_t o = (size_t)j * stride;
      const int b_hk = bh[o + k], b_hh = bh[o + k + 1], b_hl = bh[o + k - 1];
      const int b_gh = bg[o + k + 1], b_fl = bf[o + k - 1];
      if (a_hk >= b_hk) d1 = add_term(d1, xna, ygd);
      if (b_hk >= a_hk) d2 = add_term(d2, xgd, yna);
      if (a_hh >= b_hh) v1 = add_term(v1, xna, ypg);
      if (a_gh >= b_gh) v2 = add_term(v2, xna, ypg);
      if (b_hl >= a_hl) h1 = add_term(h1, xpg, yna);
      if (b_fl >= a_fl) h2 = add_term(h2, xpg, yna);
      if (LS3) {
        if (a_g2h >= (int)bg2[o + k + 1]) v3 = add_term(v3, xna, ypg);
        if ((int)bf2[o + k - 1] >= a_f2l) h3 = add_term(h3, xpg, yna);
      }
    }
  }
  out[0] = (float)d1 + (float)d2;
  out[1] = (float)v1;
  out[2] = (float)v2;
  out[3] = (float)h1;
  out[4] = (float)h2;
  out[5] = (float)v3;
  out[6] = (float)h3;
}

// The profile scores of the cells that slot pair q takes in steps d to
// d + kSpan - 1: for each, sum_c CA[c, m - 1] * CB[c, n - 1] in channel
// order.  The kSpan chains are independent, so they run interleaved;
// out-of-band cells are computed at clamped columns and never read.
__device__ __forceinline__ void channel_span(const double* __restrict__ CA,
                                             int la_max,
                                             const double* __restrict__ CB,
                                             int lb_max, int C, int d, int q,
                                             int lw, float* out, int stride) {
  int ai[kSpan], bi[kSpan];
  double s[kSpan];
#pragma unroll
  for (int j = 0; j < kSpan; ++j) {
    const int dj = d + j;
    const int k = 2 * q + ((dj - lw + 1) & 1);
    const int m = (dj - (lw - 1 + k)) >> 1;
    ai[j] = min(max(m - 1, 0), la_max - 1);
    bi[j] = min(max(dj - m - 1, 0), lb_max - 1);
    s[j] = 0.0;
  }
  for (int c = 0; c < C; ++c) {
    const double* a = CA + (size_t)c * la_max;
    const double* b = CB + (size_t)c * lb_max;
#pragma unroll
    for (int j = 0; j < kSpan; ++j)
      s[j] = add_term(s[j], __ldg(a + ai[j]), __ldg(b + bi[j]));
  }
#pragma unroll
  for (int j = 0; j < kSpan; ++j) out[j * stride] = (float)s[j];
}

// Step d of slot pair q: the idle slot of the other parity marked in the
// planes, and the live slot 2 q + par updated in place.  ``s_at`` points
// at the profile score of the live slot's cell.
template <bool LS3, typename GR>
__device__ __forceinline__ void pair_step(const Pair& p, const Lanes& S,
                                          const Runs<LS3, GR>& R, int d,
                                          int q, int par,
                                          const float* s_at, int8_t* drow,
                                          int8_t* orow) {
  const int nslot = p.nslot, lw = p.lw;
  const int kidle = 2 * q + (1 - par);
  if (kidle < nslot) {
    drow[kidle] = -1;
    orow[kidle] = 0;
  }
  const int k = 2 * q + par;
  if (k >= nslot) return;
  const int r = lw - 1 + k;
  const int m = (d - r) >> 1;
  const int n = d - m;
  if (!(m >= 0 && m <= p.la && n >= 0 && n <= p.lb && r >= lw && r <= p.up &&
        d > 0)) {
    drow[k] = -1;
    orow[k] = 0;
    return;
  }
  const int mc = min(max(m, 0), p.la_max);
  const int nc = min(max(n, 0), p.lb_max);
  const bool is_top = m == 0, is_left = n == 0;
  const int mi = min(max(m - 1, 0), p.la_max - 1);
  const int ni = min(max(n - 1, 0), p.lb_max - 1);
  const float s_cell = *s_at;
  const float b0_cell =
      (m >= 1 && n >= 1) ? __ldg(p.ea0 + mi) * __ldg(p.eb0 + ni) : 0.0f;
  const float pua = __ldg(p.cfa + mc) * __ldg(p.efb + nc) * p.neg_u;
  const float pub = __ldg(p.cfb + nc) * __ldg(p.efa + mc) * p.neg_u;
  const float gop_scale = p.gop_scale, v2divv1 = p.v2divv1;
  const float u2divu1 = p.u2divu1;

  const int klo = k - 1, khi = k + 1;
  const float Hval_lo = k > 0 ? S.H[klo] : kNevsel;
  const int8_t Hdir_lo = k > 0 ? S.Hdir[klo] : 0;
  const float Fval_lo = k > 0 ? S.F[klo] : kNevsel;
  const float Hval_hi = khi < nslot ? S.H[khi] : kNevsel;
  const int8_t Hdir_hi = khi < nslot ? S.Hdir[khi] : 0;
  const float Gval_hi = khi < nslot ? S.G[khi] : kNevsel;

  float crg[7];
  crg_sums<LS3, GR>(R, p.XA + mc, p.xs, p.YB + nc, p.ys, k, crg);

  // x + crg * gop_scale and the ls3 rate terms are fused
  // multiply-adds where the plain version's are (ops/group.py)
  // diagonal candidate (same slot, step d-2)
  const float d_val = fma_f64(crg[0], gop_scale, S.H[k] + s_cell);

  // vertical lane
  const float rgop_v = crg[1];
  const float ext_gv = fma_f64(crg[2], gop_scale, Gval_hi);
  const float gop_v = rgop_v * gop_scale;
  const float open_gv =
      LS3 ? Hval_hi + gop_v : fma_f64(rgop_v, gop_scale, Hval_hi);
  const bool open_v = (Hdir_hi != D_VERT) && (open_gv > ext_gv);
  float gv = (open_v ? open_gv : ext_gv) + pua;
  const bool vert_ok = m >= 2;
  if (!vert_ok) gv = kNevsel;

  // horizontal lane
  const float rgop_h = crg[3];
  const float ext_fv = fma_f64(crg[4], gop_scale, Fval_lo);
  const float gop_h = rgop_h * gop_scale;
  const float open_fv =
      LS3 ? Hval_lo + gop_h : fma_f64(rgop_h, gop_scale, Hval_lo);
  const bool open_h = (Hdir_lo != D_HORI) && (open_fv > ext_fv);
  float fv = (open_h ? open_fv : ext_fv) + pub;
  const bool hori_ok = n >= 2;
  if (!hori_ok) fv = kNevsel;

  // boundary chains: forced horizontal top row, vertical left column
  float top_val = open_fv + pub;
  float left_val = open_gv + pua;

  // long-gap lanes (ls=3)
  bool open_v2 = false, open_h2 = false;
  float g2v = kNevsel, f2v = kNevsel;
  if (LS3) {
    const float G2val_hi = khi < nslot ? S.G2[khi] : kNevsel;
    const float F2val_lo = k > 0 ? S.F2[klo] : kNevsel;
    const float open_g2v = fma_f64(v2divv1, gop_v, Hval_hi);
    const float ext_g2v = fma_f64(v2divv1, crg[5] * gop_scale, G2val_hi);
    open_v2 = (Hdir_hi != D_VERT) && (open_g2v > ext_g2v);
    g2v = fma_f64(u2divu1, pua, open_v2 ? open_g2v : ext_g2v);
    if (!vert_ok) g2v = kNevsel;
    const float open_f2v = fma_f64(v2divv1, gop_h, Hval_lo);
    const float ext_f2v = fma_f64(v2divv1, crg[6] * gop_scale, F2val_lo);
    open_h2 = (Hdir_lo != D_HORI) && (open_f2v > ext_f2v);
    f2v = fma_f64(u2divu1, pub, open_h2 ? open_f2v : ext_f2v);
    if (!hori_ok) f2v = kNevsel;
    // terminal runs >= k1 accrue at the long-gap rates
    if (n >= p.k1) top_val = fma_f64(u2divu1, pub, open_f2v);
    if (m >= p.k1) left_val = fma_f64(u2divu1, pua, open_g2v);
  }

  // select (lane order: g, g2 strict, f ties, f2 ties)
  float mx_val = gv;
  int8_t mx_lane = L_VERT;
  if (LS3 && g2v > mx_val) { mx_val = g2v; mx_lane = L_VERT2; }
  if (fv >= mx_val) { mx_val = fv; mx_lane = L_HORI; }
  if (LS3 && f2v >= mx_val) { mx_val = f2v; mx_lane = L_HORI2; }
  // the phase-0 intron bonus lands on the winning gap lane and
  // persists in its stored value
  if (b0_cell != 0.0f && mx_val > kNevsel * 0.5f) {
    mx_val = mx_val + b0_cell;
    if (mx_lane == L_VERT) gv = gv + b0_cell;
    if (mx_lane == L_HORI) fv = fv + b0_cell;
    if (LS3 && mx_lane == L_VERT2) g2v = g2v + b0_cell;
    if (LS3 && mx_lane == L_HORI2) f2v = f2v + b0_cell;
  }
  const bool nondiag = mx_val > d_val;
  const bool is_vlane = mx_lane == L_VERT || mx_lane == L_VERT2;
  float h_val = nondiag ? mx_val : d_val;
  int8_t h_dir = nondiag ? (is_vlane ? D_VERT : D_HORI) : D_DIAG;
  int8_t h_src = nondiag ? mx_lane : L_DIAG;
  if (is_top) {
    h_val = top_val; h_dir = D_HORI; h_src = L_HORI;
  } else if (is_left) {
    h_val = left_val; h_dir = D_VERT; h_src = L_VERT;
  }

  // per-member gap-run lengths; slot k's runs are read before they
  // are written, and no other slot reads them in this step
  for (int i = 0; i < p.an_b; ++i) {
    const bool a_gap =
        __ldg(p.XA + ((size_t)i * NCOMP + FMASK) * p.xs + mc) <= 0.0;
    GR* rh = R.a(GH, i);
    GR* rg = R.a(GG, i);
    GR* rf = R.a(GF, i);
    const int h_old = rh[k], h_hi = rh[khi], h_lo = rh[klo];
    const int g_gla = a_gap ? (open_v ? h_hi : rg[khi]) + 1 : 0;
    const int f_gla = (open_h ? h_lo : rf[klo]) + 1;
    int g2_gla = 0, f2_gla = 0;
    if (LS3) {
      g2_gla = a_gap ? (open_v2 ? h_hi : R.a(GG2, i)[khi]) + 1 : 0;
      f2_gla = (open_h2 ? h_lo : R.a(GF2, i)[klo]) + 1;
    }
    int mx = mx_lane == L_VERT ? g_gla : f_gla;
    if (LS3)
      mx = mx_lane == L_VERT ? g_gla : mx_lane == L_VERT2 ? g2_gla
         : mx_lane == L_HORI ? f_gla : f2_gla;
    int h_new = nondiag ? mx : (a_gap ? h_old + 1 : 0);
    if (is_top) h_new = h_lo + 1;
    else if (is_left) h_new = a_gap ? h_hi + 1 : 0;
    rh[k] = (GR)h_new;
    rg[k] = (GR)g_gla;
    rf[k] = (GR)f_gla;
    if (LS3) {
      R.a(GG2, i)[k] = (GR)g2_gla;
      R.a(GF2, i)[k] = (GR)f2_gla;
    }
  }
  for (int j = 0; j < p.bn_b; ++j) {
    const bool b_gap =
        __ldg(p.YB + ((size_t)j * NCOMP + FMASK) * p.ys + nc) <= 0.0;
    GR* rh = R.b(GH, j);
    GR* rg = R.b(GG, j);
    GR* rf = R.b(GF, j);
    const int h_old = rh[k], h_hi = rh[khi], h_lo = rh[klo];
    const int g_glb = (open_v ? h_hi : rg[khi]) + 1;
    const int f_glb = b_gap ? (open_h ? h_lo : rf[klo]) + 1 : 0;
    int g2_glb = 0, f2_glb = 0;
    if (LS3) {
      g2_glb = (open_v2 ? h_hi : R.b(GG2, j)[khi]) + 1;
      f2_glb = b_gap ? (open_h2 ? h_lo : R.b(GF2, j)[klo]) + 1 : 0;
    }
    int mx = mx_lane == L_VERT ? g_glb : f_glb;
    if (LS3)
      mx = mx_lane == L_VERT ? g_glb : mx_lane == L_VERT2 ? g2_glb
         : mx_lane == L_HORI ? f_glb : f2_glb;
    int h_new = nondiag ? mx : (b_gap ? h_old + 1 : 0);
    if (is_top) h_new = b_gap ? h_lo + 1 : 0;
    else if (is_left) h_new = h_hi + 1;
    rh[k] = (GR)h_new;
    rg[k] = (GR)g_glb;
    rf[k] = (GR)f_glb;
    if (LS3) {
      R.b(GG2, j)[k] = (GR)g2_glb;
      R.b(GF2, j)[k] = (GR)f2_glb;
    }
  }

  const bool inner = !is_top && !is_left;
  S.H[k] = h_val;
  S.Hdir[k] = h_dir;
  S.G[k] = inner ? gv : kNevsel;
  S.F[k] = inner ? fv : kNevsel;
  int8_t op = (open_v ? 1 : 0) + (open_h ? 2 : 0);
  if (LS3) {
    S.G2[k] = inner ? g2v : kNevsel;
    S.F2[k] = inner ? f2v : kNevsel;
    op += (open_v2 ? 4 : 0) + (open_h2 ? 8 : 0);
  }
  drow[k] = h_src;
  orow[k] = op;
}

// Slot k's lane values, Hdir and (``runs``) real members' runs from one
// copy of the pair's state into another.
template <bool LS3, typename GR>
__device__ __forceinline__ void copy_slot(const Lanes& S,
                                          const Runs<LS3, GR>& R,
                                          const Lanes& T,
                                          const Runs<LS3, GR>& TR, bool runs,
                                          int k) {
  T.H[k] = S.H[k];
  T.G[k] = S.G[k];
  T.F[k] = S.F[k];
  if (LS3) {
    T.G2[k] = S.G2[k];
    T.F2[k] = S.F2[k];
  }
  T.Hdir[k] = S.Hdir[k];
  if (!runs) return;
  for (int lane = 0; lane < lanes_of(LS3); ++lane) {
    for (int i = 0; i < R.an; ++i) TR.a(lane, i)[k] = R.a(lane, i)[k];
    for (int j = 0; j < R.bn; ++j) TR.b(lane, j)[k] = R.b(lane, j)[k];
  }
}

template <bool LS3, int VAR>
__global__ void __launch_bounds__(kMaxThreads)
group_wavefront_kernel(Args args) {
  constexpr bool SHARED = VAR == V_SHARED;
  using GR = typename std::conditional<SHARED, int16_t, int32_t>::type;
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const Pair p = pair_of(args, b);
  const int nslot = args.nslot;
  int8_t* dirs = args.dirs + (size_t)b * args.nsteps * nslot;
  int8_t* opens = args.opens + (size_t)b * args.nsteps * nslot;

  // the profile scores of the coming steps, (kSpan, npairs); then the
  // pair's state block: lane values, then (shared variant) the runs, then
  // Hdir.  The wide variant keeps the span in its scratch and the state
  // in the output carry; the global variant its runs there.
  const int npairs = (nslot + 1) / 2;
  const size_t nrun = run_words(LS3, args.an_max, args.bn_max, nslot);
  float* vf = args.valsf + (size_t)b * 5 * nslot;
  int8_t* hf = args.hdirf + (size_t)b * nslot;
  int32_t* rf = args.runsf + (size_t)b * nrun;
  float* Sspan = VAR == V_WIDE ? args.span + (size_t)b * kSpan * npairs
                               : smem;
  float* Hval = VAR == V_WIDE ? vf : Sspan + kSpan * npairs;
  GR* runs;
  int8_t* Hdir;
  if (SHARED) {
    runs = reinterpret_cast<GR*>(Hval + 5 * nslot);
    Hdir = reinterpret_cast<int8_t*>(
        reinterpret_cast<int16_t*>(Hval + 5 * nslot) + nrun);
  } else {
    runs = reinterpret_cast<GR*>(rf);
    Hdir = VAR == V_WIDE ? hf : reinterpret_cast<int8_t*>(Hval + 5 * nslot);
  }
  const Lanes S{Hval, Hval + nslot, Hval + 2 * nslot, Hval + 3 * nslot,
                Hval + 4 * nslot, Hdir};
  const Runs<LS3, GR> R{runs, p.an_b, p.bn_b, args.an_max, args.bn_max,
                        nslot + 2, 0};

  // the input carry, or the DP corner; int32 runs narrow to the shared
  // variant's int16 (the wrapper picks it only where every run fits)
  const float* v0 = args.vals0 ? args.vals0 + (size_t)b * 5 * nslot : nullptr;
  for (int k = threadIdx.x; k < nslot; k += blockDim.x) {
    if (v0) {
      S.H[k] = v0[k];
      S.G[k] = v0[nslot + k];
      S.F[k] = v0[2 * nslot + k];
      S.G2[k] = v0[3 * nslot + k];
      S.F2[k] = v0[4 * nslot + k];
      S.Hdir[k] = args.hdir0[(size_t)b * nslot + k];
    } else {
      const bool corner = p.lw - 1 + k == 0;
      S.H[k] = corner ? 0.0f : kNevsel;
      S.Hdir[k] = corner ? D_DIAG : 0;
      S.G[k] = S.F[k] = S.G2[k] = S.F2[k] = kNevsel;
    }
  }
  const int32_t* r0 = args.runs0 ? args.runs0 + (size_t)b * nrun : nullptr;
  for (size_t i = threadIdx.x; i < nrun; i += blockDim.x)
    runs[i] = r0 ? (GR)r0[i] : (GR)0;
  __syncthreads();

  // (over the step d rather than the plane row: the loop over the row
  // compiled to steps 5-19 % longer on tools/k2_bench.py's shapes on an
  // NVIDIA H100 80GB HBM3 at 700 W)
  for (int d = args.d0; d < args.d0 + args.nsteps; ++d) {
    const int row = d - args.d0;
    // a thread computes the profile scores of its own slots for the next
    // kSpan steps and alone reads them, so this needs no barrier
    if (row % kSpan == 0)
      for (int q = threadIdx.x; q < npairs; q += blockDim.x)
        channel_span(p.CA, p.la_max, p.CB, p.lb_max, p.C, d, q, p.lw,
                     Sspan + q, npairs);
    int8_t* drow = dirs + (size_t)row * nslot;
    int8_t* orow = opens + (size_t)row * nslot;
    const int par = (d - p.lw + 1) & 1;   // slots k with (d - r) even
    const float* srow = Sspan + (row % kSpan) * npairs;
    for (int q = threadIdx.x; q < npairs; q += blockDim.x)
      pair_step<LS3, GR>(p, S, R, d, q, par, srow + q, drow, orow);
    __syncthreads();
  }

  // the final state into the output carry (what the wide variant and the
  // global variant's runs already hold there)
  if (VAR != V_WIDE)
    for (int k = threadIdx.x; k < nslot; k += blockDim.x) {
      vf[k] = S.H[k];
      vf[nslot + k] = S.G[k];
      vf[2 * nslot + k] = S.F[k];
      vf[3 * nslot + k] = S.G2[k];
      vf[4 * nslot + k] = S.F2[k];
      hf[k] = S.Hdir[k];
    }
  if (SHARED)
    for (size_t i = threadIdx.x; i < nrun; i += blockDim.x) rf[i] = runs[i];
  if (threadIdx.x == 0) {
    const int k_end = (p.lb - p.la) - (p.lw - 1);
    args.score[b] = (k_end >= 0 && k_end < nslot) ? S.H[k_end] : kNevsel;
  }
}

// The cluster variant
// -------------------

// the split cluster barrier: a thread's writes before the arrive
// (release) are seen by every thread of the cluster after its wait
// (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// sections of a step (tools/k2_bench.py PROFILE_SECTIONS): the profile
// scores of the coming steps, the edge slot and its push, the interior
// slots, the CTA barrier, the cluster barrier's wait
enum { kSecSpan, kSecEdge, kSecInterior, kSecCta, kSecWait, kSections };
#ifdef K2_PROFILE
// per section the cycles summed over threads, then the threads' steps
__device__ unsigned long long k2_prof[kSections + 1];
__device__ __forceinline__ long long prof_clock() {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c));
  return c;
}
struct Prof {
  long long t, acc[kSections];
  __device__ Prof() : t(prof_clock()) {
    for (int s = 0; s < kSections; ++s) acc[s] = 0;
  }
  __device__ void mark(int sec) {
    const long long now = prof_clock();
    acc[sec] += now - t;
    t = now;
  }
  __device__ void flush(int steps) {
    for (int s = 0; s < kSections; ++s)
      atomicAdd(&k2_prof[s], (unsigned long long)acc[s]);
    atomicAdd(&k2_prof[kSections], (unsigned long long)steps);
  }
};
#else
struct Prof {
  __device__ void mark(int) {}
  __device__ void flush(int) {}
};
#endif

// A cluster CTA's lane values and Hdir, in its own shared memory or (by
// ``base`` mapped into the cluster) a neighbour's, indexed by slot for a
// slice whose first slot is s0: slot k at k + 1 - s0 of each array.
// ``run_bytes``: the bytes of the runs in shared memory before Hdir.
__device__ __forceinline__ Lanes cluster_lanes(float* base, int pc,
                                               size_t run_bytes, int s0) {
  const int n2 = 2 * pc + 2;
  float* H = base + kSpan * pc;
  int8_t* Hdir = reinterpret_cast<int8_t*>(H + 5 * n2) + run_bytes;
  return Lanes{H + 1 - s0, H + n2 + 1 - s0, H + 2 * n2 + 1 - s0,
               H + 3 * n2 + 1 - s0, H + 4 * n2 + 1 - s0, Hdir + 1 - s0};
}

// the first slot pair of CTA r's slice of a cluster of P
__device__ __forceinline__ int slice_start(int r, int npairs, int P) {
  return (int)((long long)r * npairs / P);
}

// The cluster variant: pair blockIdx.x / ctas over a cluster of ctas
// CTAs, CTA r on slot pairs slice_start(r) to slice_start(r + 1) - 1.
// RB 2 or 4: the runs as rows of int16 or int32 over the slice and its
// halo in shared memory; RB 0: as int32 in the output carry, shared by
// the cluster.
template <bool LS3, int RB>
__global__ void __launch_bounds__(kMaxThreads)
group_wavefront_cluster(Args args) {
  constexpr bool SRUNS = RB != 0;
  using GR = typename std::conditional<RB == 2, int16_t, int32_t>::type;
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int P = args.ctas, pc = args.pc;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / P;
  const Pair p = pair_of(args, b);
  const int nslot = args.nslot, npairs = (nslot + 1) / 2;
  const int T = blockDim.x, t = threadIdx.x;
  int8_t* dirs = args.dirs + (size_t)b * args.nsteps * nslot;
  int8_t* opens = args.opens + (size_t)b * args.nsteps * nslot;

  // this CTA's slice: slot pairs q0 to q1 - 1, slots s0 to s1 - 1
  const int q0 = slice_start(rank, npairs, P);
  const int q1 = slice_start(rank + 1, npairs, P);
  const int s0 = 2 * q0, s1 = min(2 * q1, nslot);
  const int n2 = 2 * pc + 2;
  const int rows = lanes_of(LS3) * (args.an_max + args.bn_max);
  const size_t nrun = run_words(LS3, args.an_max, args.bn_max, nslot);
  const size_t sbytes = RB * run_words(LS3, args.an_max, args.bn_max, 2 * pc);
  float* vf = args.valsf + (size_t)b * 5 * nslot;
  int8_t* hf = args.hdirf + (size_t)b * nslot;
  int32_t* rf = args.runsf + (size_t)b * nrun;

  // the span of its pairs (kSpan, pc), then the slice's state with its
  // halo: lane values, the runs (SRUNS), Hdir
  float* Sspan = smem;
  const Lanes S = cluster_lanes(smem, pc, sbytes, s0);
  GR* runs = SRUNS ? reinterpret_cast<GR*>(smem + kSpan * pc + 5 * n2)
                   : reinterpret_cast<GR*>(rf);
  const Runs<LS3, GR> R{runs, p.an_b, p.bn_b, args.an_max, args.bn_max,
                        SRUNS ? n2 : nslot + 2, SRUNS ? s0 : 0};
  // the neighbours' copies of this slice's edge slots: the previous
  // CTA's halo after its last slot and the next one's before its first
  Lanes NL = S, NH = S;
  Runs<LS3, GR> NLr = R, NHr = R;
  if (rank > 0) {
    const int s = 2 * slice_start(rank - 1, npairs, P);
    float* nb = cluster.map_shared_rank(smem, rank - 1);
    NL = cluster_lanes(nb, pc, sbytes, s);
    NLr.base = reinterpret_cast<GR*>(nb + kSpan * pc + 5 * n2);
    NLr.shift = s;
  }
  if (rank < P - 1) {
    float* nb = cluster.map_shared_rank(smem, rank + 1);
    NH = cluster_lanes(nb, pc, sbytes, s1);
    NHr.base = reinterpret_cast<GR*>(nb + kSpan * pc + 5 * n2);
    NHr.shift = s1;
  }

  // the slice and its halo slots from the input carry, or the DP corner;
  // a halo slot past the band's ends holds what an edge slot reads there
  const float* v0 = args.vals0 ? args.vals0 + (size_t)b * 5 * nslot : nullptr;
  for (int k = s0 - 1 + t; k <= s1; k += T) {
    if (k < 0 || k >= nslot) {
      S.H[k] = S.G[k] = S.F[k] = S.G2[k] = S.F2[k] = kNevsel;
      S.Hdir[k] = 0;
    } else if (v0) {
      S.H[k] = v0[k];
      S.G[k] = v0[nslot + k];
      S.F[k] = v0[2 * nslot + k];
      S.G2[k] = v0[3 * nslot + k];
      S.F2[k] = v0[4 * nslot + k];
      S.Hdir[k] = args.hdir0[(size_t)b * nslot + k];
    } else {
      const bool corner = p.lw - 1 + k == 0;
      S.H[k] = corner ? 0.0f : kNevsel;
      S.Hdir[k] = corner ? D_DIAG : 0;
      S.G[k] = S.F[k] = S.G2[k] = S.F2[k] = kNevsel;
    }
  }
  // the runs: in shared memory the slice's row words and the halo's
  // (row index s0 to s1 + 1); in the output carry the slice's (s0 + 1 to
  // s1), with the first CTA taking index 0 and the last nslot + 1
  const int32_t* r0 = args.runs0 ? args.runs0 + (size_t)b * nrun : nullptr;
  const int lo = SRUNS ? 0 : (rank == 0 ? 0 : s0 + 1);
  const int hi = SRUNS ? s1 - s0 + 2 : (rank == P - 1 ? nslot + 2 : s1 + 1);
  for (int i = t; i < rows * (hi - lo); i += T) {
    const int row = i / (hi - lo), j = lo + i % (hi - lo);
    const size_t from = (size_t)row * (nslot + 2) + (SRUNS ? s0 + j : j);
    const size_t to = SRUNS ? (size_t)row * n2 + j : from;
    runs[to] = r0 ? (GR)r0[from] : (GR)0;
  }
  cluster_arrive();
  cluster_wait();

  Prof pf;
  for (int d = args.d0; d < args.d0 + args.nsteps; ++d) {
    const int row = d - args.d0;
    // a thread computes the profile scores of its own pairs for the next
    // kSpan steps and alone reads them, so this needs no barrier
    if (row % kSpan == 0)
      for (int q = q0 + t; q < q1; q += T)
        channel_span(p.CA, p.la_max, p.CB, p.lb_max, p.C, d, q, p.lw,
                     Sspan + (q - q0), pc);
    pf.mark(kSecSpan);
    int8_t* drow = dirs + (size_t)row * nslot;
    int8_t* orow = opens + (size_t)row * nslot;
    const int par = (d - p.lw + 1) & 1;
    const float* srow = Sspan + (row % kSpan) * pc - q0;
    // the pair whose live slot a neighbour reads at step d + 1: the
    // slice's first slot in an even step, its last in an odd one
    const int qe = par == 0 ? (rank > 0 ? q0 : -1)
                            : (rank < P - 1 ? q1 - 1 : -1);
    if (qe >= 0 && t == (qe - q0) % T) {
      pair_step<LS3, GR>(p, S, R, d, qe, par, srow + qe, drow, orow);
      if (par == 0)
        copy_slot<LS3, GR>(S, R, NL, NLr, SRUNS, s0);
      else
        copy_slot<LS3, GR>(S, R, NH, NHr, SRUNS, s1 - 1);
    }
    pf.mark(kSecEdge);
    cluster_arrive();
    for (int q = q0 + t; q < q1; q += T)
      if (q != qe) pair_step<LS3, GR>(p, S, R, d, q, par, srow + q, drow, orow);
    pf.mark(kSecInterior);
    __syncthreads();
    pf.mark(kSecCta);
    cluster_wait();
    pf.mark(kSecWait);
  }
  pf.flush(args.nsteps);

  // the slice's final state into the output carry (the runs in device
  // memory are there already); rows past a pair's real members as they
  // came in
  for (int k = s0 + t; k < s1; k += T) {
    vf[k] = S.H[k];
    vf[nslot + k] = S.G[k];
    vf[2 * nslot + k] = S.F[k];
    vf[3 * nslot + k] = S.G2[k];
    vf[4 * nslot + k] = S.F2[k];
    hf[k] = S.Hdir[k];
  }
  if (SRUNS) {
    const int wlo = rank == 0 ? 0 : 1;
    const int whi = s1 - s0 + (rank == P - 1 ? 2 : 1);
    for (int i = t; i < rows * (whi - wlo); i += T) {
      const int row = i / (whi - wlo), j = wlo + i % (whi - wlo);
      rf[(size_t)row * (nslot + 2) + s0 + j] = runs[(size_t)row * n2 + j];
    }
  }
  const int k_end = (p.lb - p.la) - (p.lw - 1);
  const bool in = k_end >= 0 && k_end < nslot;
  if (t == 0 && (in ? k_end >= s0 && k_end < s1 : rank == 0))
    args.score[b] = in ? S.H[k_end] : kNevsel;
}

#ifdef K2_PROFILE
// The chain a step of the cluster variant cannot go below: thread 0 of
// each CTA reads a value its predecessor pushed, pushes it plus one into
// its successor's shared memory, and every thread takes the split
// cluster barrier, ``steps`` times.
__global__ void k2_barrier_chain(int steps, float* out) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int P = (int)cluster.num_blocks();
  float* next = cluster.map_shared_rank(smem, (rank + 1) % P);
  if (threadIdx.x == 0) smem[0] = smem[1] = 0.0f;
  cluster_arrive();
  cluster_wait();
  for (int s = 0; s < steps; ++s) {
    if (threadIdx.x == 0) next[s & 1] = smem[(s + 1) & 1] + 1.0f;
    cluster_arrive();
    __syncthreads();
    cluster_wait();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = smem[(steps + 1) & 1];
}
#endif

}  // namespace

#ifdef K2_PROFILE
// the profile's sums (kSections, then the steps they cover), cleared
// after the read if ``clear``
extern "C" int k2_profile_read(void* out, int clear) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k2_prof, sizeof(k2_prof));
  if (e == cudaSuccess && clear) {
    unsigned long long z[kSections + 1] = {};
    e = cudaMemcpyToSymbol(k2_prof, z, sizeof(z));
  }
  return (int)e;
}

// one launch of the barrier chain: a cluster of ``ctas`` CTAs of
// ``threads`` threads, ``steps`` steps; out: ctas floats
extern "C" int k2_barrier_chain_launch(int ctas, int threads, int steps,
                                       void* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      k2_barrier_chain, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 2 * sizeof(float);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k2_barrier_chain, steps, (float*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
#endif

namespace {

int block_threads(int pairs) {
  const int threads = (pairs + 31) / 32 * 32;
  return threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
}

template <bool LS3, int VAR>
int launch(const Args& args, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      group_wavefront_kernel<LS3, VAR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  group_wavefront_kernel<LS3, VAR>
      <<<B, block_threads((args.nslot + 1) / 2), smem, stream>>>(args);
  return (int)cudaGetLastError();
}

// B clusters of args.ctas CTAs; refused (cudaErrorInvalidConfiguration)
// where the card cannot hold one such cluster
template <bool LS3, int RB>
int launch_cluster(const Args& args, int B, size_t smem,
                   cudaStream_t stream) {
  const auto kernel = group_wavefront_cluster<LS3, RB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * args.ctas, 1, 1);
  cfg.blockDim = dim3(block_threads(args.pc), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = args.ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  bool fits = false;
  err = prrn_kernels::cluster_fits((const void*)kernel, cfg, &fits);
  if (err != cudaSuccess) return (int)err;
  if (!fits) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool LS3>
const void* kernel_of(int variant, int run_bytes) {
  if (variant == V_CLUSTER)
    return run_bytes == 2   ? (const void*)group_wavefront_cluster<LS3, 2>
           : run_bytes == 4 ? (const void*)group_wavefront_cluster<LS3, 4>
                            : (const void*)group_wavefront_cluster<LS3, 0>;
  return variant == V_SHARED ? (const void*)group_wavefront_kernel<LS3, V_SHARED>
         : variant == V_WIDE ? (const void*)group_wavefront_kernel<LS3, V_WIDE>
                             : (const void*)group_wavefront_kernel<LS3, V_GLOBAL>;
}

template <bool LS3>
int launch_variant(const Args& args, int B, size_t smem, int variant,
                   int run_bytes, cudaStream_t s) {
  if (variant == V_CLUSTER)
    return run_bytes == 2   ? launch_cluster<LS3, 2>(args, B, smem, s)
           : run_bytes == 4 ? launch_cluster<LS3, 4>(args, B, smem, s)
                            : launch_cluster<LS3, 0>(args, B, smem, s);
  return variant == V_SHARED ? launch<LS3, V_SHARED>(args, B, smem, s)
         : variant == V_WIDE ? launch<LS3, V_WIDE>(args, B, smem, s)
                             : launch<LS3, V_GLOBAL>(args, B, smem, s);
}

}  // namespace

// ``variant`` (0 global, 1 shared, 2 wide, 3 cluster: where the state
// block lives) is chosen by the wrapper by size
// (ops/group.py::wavefront_plan); one whose shared memory does not fit is
// refused.  The cluster variant takes ``ctas`` CTAs a pair (1 to 16, at
// least a slot pair each) and keeps the runs in shared memory in words of
// ``run_bytes`` (2, which needs la_max + lb_max < 32767, or 4; 0: in
// device memory); the others take ctas 1 and run_bytes 2 for the shared
// variant, else 0.
// vals0/hdir0/runs0 are the input carry (all null: start at the DP
// corner), valsf/hdirf/runsf the output carry; ``span`` the wide
// variant's scratch.
extern "C" int group_wavefront_launch(
    const void* CA, const void* CB, const void* XA, const void* YB,
    const void* ea0, const void* eb0, const void* cfa, const void* efa, const void* cfb, const void* efb,
    const void* iprm, const void* fprm, void* score,
    void* dirs, void* opens, const void* vals0, const void* hdir0,
    const void* runs0, void* valsf, void* hdirf, void* runsf, void* span,
    int B, int C, int an, int bn, int an_max, int bn_max,
    int la_max, int lb_max, int nslot, int nsteps, int d0, int ls3,
    int variant, int ctas, int run_bytes, void* stream) {
  const int npairs = (nslot + 1) / 2;
  const int pc = ctas > 0 ? (npairs + ctas - 1) / ctas : 0;
  Args args{(const double*)CA, (const double*)CB, (const double*)XA,
            (const double*)YB, (const float*)ea0, (const float*)eb0,
            (const float*)cfa,
            (const float*)efa, (const float*)cfb, (const float*)efb,
            (const int32_t*)iprm, (const float*)fprm,
            (float*)score,
            (int8_t*)dirs, (int8_t*)opens,
            (const float*)vals0, (const int8_t*)hdir0, (const int32_t*)runs0,
            (float*)valsf, (int8_t*)hdirf, (int32_t*)runsf, (float*)span,
            C, an, bn, an_max, bn_max, la_max, lb_max, nslot, nsteps, d0,
            ctas, pc};
  const bool cluster = variant == V_CLUSTER;
  if (variant < V_GLOBAL || variant > V_CLUSTER || d0 < 0 || nslot < 1 ||
      (variant == V_WIDE && span == nullptr) ||
      ((vals0 == nullptr) != (runs0 == nullptr)) ||
      ((vals0 == nullptr) != (hdir0 == nullptr)) ||
      (cluster ? ctas < 1 || ctas > kClusterMax || ctas > npairs ||
                     (run_bytes != 0 && run_bytes != 2 && run_bytes != 4) ||
                     (run_bytes == 2 && la_max + lb_max >= 32767)
               : ctas != 1 || run_bytes != (variant == V_SHARED ? 2 : 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      cluster ? cluster_smem_bytes(ls3, run_bytes, an_max, bn_max, pc)
              : smem_bytes(ls3, variant, an_max, bn_max, nslot);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return ls3 ? launch_variant<true>(args, B, smem, variant, run_bytes, s)
             : launch_variant<false>(args, B, smem, variant, run_bytes, s);
}

// Registers a thread and local (spilled) bytes of one instantiation (the
// cluster variant's with its runs in words of ``run_bytes``).
extern "C" int group_wavefront_attrs(int ls3, int variant, int run_bytes,
                                     void* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, ls3 ? kernel_of<true>(variant, run_bytes)
              : kernel_of<false>(variant, run_bytes));
  if (err != cudaSuccess) return (int)err;
  int* o = (int*)out;
  o[0] = a.numRegs;
  o[1] = (int)a.localSizeBytes;
  return 0;
}
