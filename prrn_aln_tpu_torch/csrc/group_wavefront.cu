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
// 1, bucketed) with one __syncthreads each.  In a step each live slot
// takes the exact gap-open counts (crg) as six sums over its member
// pairs (eight with ls3), each a chain of f64 adds rounded to f32, and
// the profile score of its cell, a chain over the C channels.
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
//   device memory (in the output carry itself); where even the lane
//   values and the profile-score span do not fit (a band past ~6,200
//   slots), the "wide" variant keeps them in device memory too: the lane
//   values and Hdir in the output carry, the span in a scratch a pair.
//   One block a pair and one __syncthreads() a step still suffice: the
//   barrier orders the block's device-memory writes before its reads as
//   it does its shared ones.  The state of 24,000 slots (~1.1 MB with one
//   member a side) stays in L2.
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
//
// What bounds it (tools/k2_bench.py, loops cut one at a time, on an
// H100): a pair runs on one SM, a step at a time.  With many real member
// pairs the crg chains do: each term is an f64 add between two
// conversions, ~0.1 us a real member pair a step at nslot 640 (9 of a
// 16.8 us step at 90 pairs).  With few members (ce13a17's merges) a step
// takes ~5 us, of which cutting the profile scores saves 1.6 and cutting
// all three loops leaves 1.2 (barrier, lane update, plane stores).  Shared
// memory bounds the members the shared variant holds: with nslot 768 and
// three lanes about 70 on the two sides together.  The wide variant on a
// 20 kb DNA pair (24,064 slots, one member a side) takes 76.6 us a step
// on its one SM (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W): ~23 live
// slots a thread, and by a reckoning about half of the step is the SM's
// f64/f32 conversions of the profile and crg sums (16 a clock).  Registers (sm_90a, CUDA 12.8, attrs): 128 for the
// global, shared and wide variants; with ls3 125, 96 and 128 (8 bytes
// spilled); one barrier.
//
// Sums of products (the crg sums and the profile score) run in one fixed
// order, each term added like a fused multiply-add: the product in f64
// (exact for f32 factors) is added to the f32 sum in f64 and the result
// rounded to f32.  The gap costs added to lane values are fused the same
// way where the JAX reference's are on the CPU; the plain version
// computes every one of these identically.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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
constexpr int V_GLOBAL = 0, V_SHARED = 1, V_WIDE = 2;
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

// One pair's gap-run rows; slot k of a row is at index k + 1.  The pair
// walks its an (bn) real members; rows are laid out for the batch's
// an_max (bn_max).
template <bool LS3, typename GR>
struct Runs {
  GR* base;
  int an, bn, arows, brows, stride;
  __device__ GR* a(int lane, int i) const {
    return base + (size_t)(lane * arows + i) * stride + 1;
  }
  __device__ GR* b(int lane, int j) const {
    return base + (size_t)(lanes_of(LS3) * arows + lane * brows + j) *
                      stride + 1;
  }
};

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

template <bool LS3, int VAR>
__global__ void __launch_bounds__(kMaxThreads)
group_wavefront_kernel(Args args) {
  constexpr bool SHARED = VAR == V_SHARED;
  using GR = typename std::conditional<SHARED, int16_t, int32_t>::type;
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int nslot = args.nslot, an = args.an, bn = args.bn;
  const int la_max = args.la_max, lb_max = args.lb_max, C = args.C;
  const int32_t* ip = args.iprm + 7 * b;
  const int la = ip[0], lb = ip[1], lw = ip[2], up = ip[3], k1 = ip[4];
  const int an_b = ip[5], bn_b = ip[6];
  const float u = args.fprm[4 * b + 0], gop_scale = args.fprm[4 * b + 1];
  const float v2divv1 = args.fprm[4 * b + 2], u2divu1 = args.fprm[4 * b + 3];
  const float neg_u = -u;

  const double* __restrict__ CA = args.CA + (size_t)b * la_max * C;
  const double* __restrict__ CB = args.CB + (size_t)b * lb_max * C;
  const int xs = la_max + 1, ys = lb_max + 1;
  const double* __restrict__ XA = args.XA + (size_t)b * an * NCOMP * xs;
  const double* __restrict__ YB = args.YB + (size_t)b * bn * NCOMP * ys;
  const float* __restrict__ ea0 = args.ea0 + (size_t)b * la_max;
  const float* __restrict__ eb0 = args.eb0 + (size_t)b * lb_max;
  const float* __restrict__ cfa = args.cfa + (size_t)b * (la_max + 1);
  const float* __restrict__ efa = args.efa + (size_t)b * (la_max + 1);
  const float* __restrict__ cfb = args.cfb + (size_t)b * (lb_max + 1);
  const float* __restrict__ efb = args.efb + (size_t)b * (lb_max + 1);
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
  float* Gval = Hval + nslot;
  float* Fval = Gval + nslot;
  float* G2val = Fval + nslot;
  float* F2val = G2val + nslot;
  GR* runs;
  int8_t* Hdir;
  if (SHARED) {
    runs = reinterpret_cast<GR*>(F2val + nslot);
    Hdir = reinterpret_cast<int8_t*>(
        reinterpret_cast<int16_t*>(F2val + nslot) + nrun);
  } else {
    runs = reinterpret_cast<GR*>(rf);
    Hdir = VAR == V_WIDE ? hf : reinterpret_cast<int8_t*>(F2val + nslot);
  }
  const Runs<LS3, GR> R{runs, an_b, bn_b, args.an_max, args.bn_max,
                        nslot + 2};

  // the input carry, or the DP corner; int32 runs narrow to the shared
  // variant's int16 (the wrapper picks it only where every run fits)
  const float* v0 = args.vals0 ? args.vals0 + (size_t)b * 5 * nslot : nullptr;
  for (int k = threadIdx.x; k < nslot; k += blockDim.x) {
    if (v0) {
      Hval[k] = v0[k];
      Gval[k] = v0[nslot + k];
      Fval[k] = v0[2 * nslot + k];
      G2val[k] = v0[3 * nslot + k];
      F2val[k] = v0[4 * nslot + k];
      Hdir[k] = args.hdir0[(size_t)b * nslot + k];
    } else {
      const bool corner = lw - 1 + k == 0;
      Hval[k] = corner ? 0.0f : kNevsel;
      Hdir[k] = corner ? D_DIAG : 0;
      Gval[k] = Fval[k] = G2val[k] = F2val[k] = kNevsel;
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
        channel_span(CA, la_max, CB, lb_max, C, d, q, lw, Sspan + q, npairs);
    int8_t* drow = dirs + (size_t)row * nslot;
    int8_t* orow = opens + (size_t)row * nslot;
    const int par = (d - lw + 1) & 1;   // slots k with (d - r) even
    for (int q = threadIdx.x; q < npairs; q += blockDim.x) {
      const int kidle = 2 * q + (1 - par);
      if (kidle < nslot) {
        drow[kidle] = -1;
        orow[kidle] = 0;
      }
      const int k = 2 * q + par;
      if (k >= nslot) continue;
      const int r = lw - 1 + k;
      const int m = (d - r) >> 1;
      const int n = d - m;
      if (!(m >= 0 && m <= la && n >= 0 && n <= lb && r >= lw && r <= up &&
            d > 0)) {
        drow[k] = -1;
        orow[k] = 0;
        continue;
      }
      const int mc = min(max(m, 0), la_max);
      const int nc = min(max(n, 0), lb_max);
      const bool is_top = m == 0, is_left = n == 0;
      const int mi = min(max(m - 1, 0), la_max - 1);
      const int ni = min(max(n - 1, 0), lb_max - 1);
      const float s_cell = Sspan[(row % kSpan) * npairs + q];
      const float b0_cell =
          (m >= 1 && n >= 1) ? __ldg(ea0 + mi) * __ldg(eb0 + ni) : 0.0f;
      const float pua = __ldg(cfa + mc) * __ldg(efb + nc) * neg_u;
      const float pub = __ldg(cfb + nc) * __ldg(efa + mc) * neg_u;

      const int klo = k - 1, khi = k + 1;
      const float Hval_lo = k > 0 ? Hval[klo] : kNevsel;
      const int8_t Hdir_lo = k > 0 ? Hdir[klo] : 0;
      const float Fval_lo = k > 0 ? Fval[klo] : kNevsel;
      const float Hval_hi = khi < nslot ? Hval[khi] : kNevsel;
      const int8_t Hdir_hi = khi < nslot ? Hdir[khi] : 0;
      const float Gval_hi = khi < nslot ? Gval[khi] : kNevsel;

      float crg[7];
      crg_sums<LS3, GR>(R, XA + mc, xs, YB + nc, ys, k, crg);

      // x + crg * gop_scale and the ls3 rate terms are fused
      // multiply-adds where the plain version's are (ops/group.py)
      // diagonal candidate (same slot, step d-2)
      const float d_val = fma_f64(crg[0], gop_scale, Hval[k] + s_cell);

      // vertical lane
      const float rgop_v = crg[1];
      const float ext_gv = fma_f64(crg[2], gop_scale, Gval_hi);
      const float gop_v = rgop_v * gop_scale;
      const float open_gv = LS3 ? Hval_hi + gop_v : fma_f64(rgop_v, gop_scale, Hval_hi);
      const bool open_v = (Hdir_hi != D_VERT) && (open_gv > ext_gv);
      float gv = (open_v ? open_gv : ext_gv) + pua;
      const bool vert_ok = m >= 2;
      if (!vert_ok) gv = kNevsel;

      // horizontal lane
      const float rgop_h = crg[3];
      const float ext_fv = fma_f64(crg[4], gop_scale, Fval_lo);
      const float gop_h = rgop_h * gop_scale;
      const float open_fv = LS3 ? Hval_lo + gop_h : fma_f64(rgop_h, gop_scale, Hval_lo);
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
        const float G2val_hi = khi < nslot ? G2val[khi] : kNevsel;
        const float F2val_lo = k > 0 ? F2val[klo] : kNevsel;
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
        if (n >= k1) top_val = fma_f64(u2divu1, pub, open_f2v);
        if (m >= k1) left_val = fma_f64(u2divu1, pua, open_g2v);
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
      for (int i = 0; i < an_b; ++i) {
        const bool a_gap =
            __ldg(XA + ((size_t)i * NCOMP + FMASK) * xs + mc) <= 0.0;
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
      for (int j = 0; j < bn_b; ++j) {
        const bool b_gap =
            __ldg(YB + ((size_t)j * NCOMP + FMASK) * ys + nc) <= 0.0;
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
      Hval[k] = h_val;
      Hdir[k] = h_dir;
      Gval[k] = inner ? gv : kNevsel;
      Fval[k] = inner ? fv : kNevsel;
      int8_t op = (open_v ? 1 : 0) + (open_h ? 2 : 0);
      if (LS3) {
        G2val[k] = inner ? g2v : kNevsel;
        F2val[k] = inner ? f2v : kNevsel;
        op += (open_v2 ? 4 : 0) + (open_h2 ? 8 : 0);
      }
      drow[k] = h_src;
      orow[k] = op;
    }
    __syncthreads();
  }

  // the final state into the output carry (what the wide variant and the
  // global variant's runs already hold there)
  if (VAR != V_WIDE)
    for (int k = threadIdx.x; k < nslot; k += blockDim.x) {
      vf[k] = Hval[k];
      vf[nslot + k] = Gval[k];
      vf[2 * nslot + k] = Fval[k];
      vf[3 * nslot + k] = G2val[k];
      vf[4 * nslot + k] = F2val[k];
      hf[k] = Hdir[k];
    }
  if (SHARED)
    for (size_t i = threadIdx.x; i < nrun; i += blockDim.x) rf[i] = runs[i];
  if (threadIdx.x == 0) {
    const int k_end = (lb - la) - (lw - 1);
    args.score[b] = (k_end >= 0 && k_end < nslot) ? Hval[k_end] : kNevsel;
  }
}

template <bool LS3, int VAR>
int launch(const Args& args, int B, size_t smem, cudaStream_t stream) {
  int threads = ((args.nslot + 1) / 2 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  cudaError_t err = cudaFuncSetAttribute(
      group_wavefront_kernel<LS3, VAR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  group_wavefront_kernel<LS3, VAR><<<B, threads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <bool LS3>
const void* kernel_of(int variant) {
  return variant == V_SHARED ? (const void*)group_wavefront_kernel<LS3, V_SHARED>
         : variant == V_WIDE ? (const void*)group_wavefront_kernel<LS3, V_WIDE>
                             : (const void*)group_wavefront_kernel<LS3, V_GLOBAL>;
}

}  // namespace

// ``variant`` (0 global, 1 shared, 2 wide: where the state block lives)
// is chosen by the wrapper by size (ops/group.py::wavefront_plan); one
// whose shared memory does not fit is refused.  vals0/hdir0/runs0 are
// the input carry (all null: start at the DP corner), valsf/hdirf/runsf
// the output carry; ``span`` the wide variant's scratch.
extern "C" int group_wavefront_launch(
    const void* CA, const void* CB, const void* XA, const void* YB,
    const void* ea0, const void* eb0, const void* cfa, const void* efa, const void* cfb, const void* efb,
    const void* iprm, const void* fprm, void* score,
    void* dirs, void* opens, const void* vals0, const void* hdir0,
    const void* runs0, void* valsf, void* hdirf, void* runsf, void* span,
    int B, int C, int an, int bn, int an_max, int bn_max,
    int la_max, int lb_max, int nslot, int nsteps, int d0, int ls3,
    int variant, void* stream) {
  Args args{(const double*)CA, (const double*)CB, (const double*)XA,
            (const double*)YB, (const float*)ea0, (const float*)eb0,
            (const float*)cfa,
            (const float*)efa, (const float*)cfb, (const float*)efb,
            (const int32_t*)iprm, (const float*)fprm,
            (float*)score,
            (int8_t*)dirs, (int8_t*)opens,
            (const float*)vals0, (const int8_t*)hdir0, (const int32_t*)runs0,
            (float*)valsf, (int8_t*)hdirf, (int32_t*)runsf, (float*)span,
            C, an, bn, an_max, bn_max, la_max, lb_max, nslot, nsteps, d0};
  if (variant < V_GLOBAL || variant > V_WIDE || d0 < 0 ||
      (variant == V_WIDE && span == nullptr) ||
      ((vals0 == nullptr) != (runs0 == nullptr)) ||
      ((vals0 == nullptr) != (hdir0 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(ls3, variant, an_max, bn_max, nslot);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (ls3)
    return variant == V_SHARED ? launch<true, V_SHARED>(args, B, smem, s)
           : variant == V_WIDE ? launch<true, V_WIDE>(args, B, smem, s)
                               : launch<true, V_GLOBAL>(args, B, smem, s);
  return variant == V_SHARED ? launch<false, V_SHARED>(args, B, smem, s)
         : variant == V_WIDE ? launch<false, V_WIDE>(args, B, smem, s)
                             : launch<false, V_GLOBAL>(args, B, smem, s);
}

// Registers a thread and local (spilled) bytes of one instantiation.
extern "C" int group_wavefront_attrs(int ls3, int variant, void* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(
      &a, ls3 ? kernel_of<true>(variant) : kernel_of<false>(variant));
  if (err != cudaSuccess) return (int)err;
  int* o = (int*)out;
  o[0] = a.numRegs;
  o[1] = (int)a.localSizeBytes;
  return 0;
}
