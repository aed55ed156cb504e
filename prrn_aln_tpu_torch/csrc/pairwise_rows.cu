// Kernel K1f: batched banded affine-gap (Gotoh) DP, score only, swept
// row by row.
//
// Replaces prrn_aln_tpu/ops/pallas_pairwise.py::_kernel_rows_fused (the
// TPU row sweep with the in-kernel score build, launched by
// _prepare_and_launch_fused).  Its plain PyTorch version is
// ops/pairwise.py::row_scores_ref, a transcription of that kernel's row
// loop; this kernel runs the same f32 operations (built with
// -fmad=false) and takes maxima, which are exact in any order, so the
// scores are equal bit for bit.
//
// The function.  Lane j of row m holds column n = m + lw0 + j, so the
// diagonal predecessor sits on the same lane and the vertical one on
// lane j + 1.  With X the gap-free part of a cell, the horizontal gap
// E(n) = max(E(n-1) - u, X(n-1) - v - u) is a running maximum over the
// row, E = cummax_j(C + j*u) - j*u with C(j) = X(j-1) - v - u, so a
// pair takes La dependent rows instead of La + Lb - 1 anti-diagonals.
// Every pair sweeps the batch's W lanes, as the plain version does.
//
// The score lookup.  The TPU has no gather, so it selected
// mtx[a[m], b[n]] as a one-hot (K, 32) x (32, WW) product on its matrix
// unit.  A one-hot product returns exactly one matrix entry, so here the
// same numbers come from a lookup in shared memory.  Columns outside b's
// array read 0, as the TPU kernel's out-of-range code selects its zero
// row: the register variants give the matrix a zero column `dim` and
// such a column the code `dim`.
//
// What bounds it on the card: the chain of La rows, each a running
// maximum across the band.  Device-memory traffic is tiny: the two code
// rows and the matrix.  So a row's latency sets the pace of a small
// batch, and the instructions a warp can start that of a batch that
// fills the card.
//
// What the design does about it (the register variants): a thread holds
// L adjacent lanes' H and G in registers, and their b codes as a window
// that shifts by one column a row (one new code a row).  A row forms X
// and the new G of each lane from the thread's own registers and, for
// its last lane, the next thread's first lane by one __shfl_down_sync;
// X of the lane left of its first lane comes by one __shfl_up_sync.  The
// running maximum is a serial maximum over the thread's L lanes, a warp
// scan of five shuffles, and the carry folded into the L prefixes kept
// in registers.  Since a rounded subtraction is monotone,
// max(P, carry) - j*u = max(P - j*u, carry - j*u), so a lane keeps
// Y = max(X, P - j*u) in the place of its old H, and H = max(Y,
// carry - j*u): no second array.
//
// Variants (ops/pairwise.py::rows_plan chooses by band width):
// "warp", one warp a pair and several pairs a block, with no barrier in
// the row loop; "warps", several warps a pair (one pair a block): each
// warp publishes its scan total, its first lane's Y and new G and its
// last lane's Y and in-warp carry into double-buffered shared slots, and
// the warps meet at one named barrier a row, after which each warp
// finishes its neighbours' edge lanes itself; "cluster", the "warps"
// variant's row step on each CTA of a thread-block cluster of up to 16 a
// pair, CTA r on the r-th slice of the lanes, for bands wider than one
// CTA of the "warps" variant holds (8,192 lanes); "block", the first
// design (one block of up to 1,024 threads a pair, the row in shared
// memory, two block barriers a row) past what one cluster holds, or when
// asked for.
//
// The cluster variant.  A row's running maximum can carry across the
// whole band in one row, so there is no ghost zone to compute ahead (as
// K1's cluster variant does along anti-diagonals): every row crosses the
// CTAs once.  After its warps' named barrier, each CTA pushes through
// distributed shared memory, into slots of this row's parity: its total
// (the maximum of C + j*u over its lanes) into every CTA to its right, its
// first lane's Y and new G into the CTA to its left, and its last lane's
// Y and carry within the CTA into the CTA to its right.  One split
// cluster barrier (arrive.release, wait.acquire) a row; then each CTA
// folds the totals of the CTAs to its left into its carry and finishes
// its edge lanes as the warps do theirs.  A maximum is exact in any
// order, so the fold's order changes no bit.  The slots alternate by
// row, so a push never lands on a slot a slower CTA still reads: it read
// them before its next arrive, which the pusher waited for.  On an H100
// a row of 16 CTAs takes ~1.7 us, ~0.6 us of it the barrier
// (tools/k1k3_bench.py --ablate k1f_nocluster); the rest is the "warps"
// step's chain, which wider threads (8 lanes or more) shorten.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_fits.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kNegSent = -1879048192.0f;   // -(2**31 // 8) * 7
constexpr float kNevsel = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFar = 1 << 30;                // a lane index no lane has

// inclusive running maximum over the lanes of a warp
__device__ __forceinline__ float warp_cummax(float x, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x = fmaxf(x, y);
  }
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ void named_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// the split cluster barrier: a thread's writes before the arrive
// (release) are seen by every thread of the cluster after its wait
// (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

struct RowPair {
  int La, Lb, LW, UP;
  float u, v, fa_l, fa_r, fb_l, fb_r;
};

__device__ __forceinline__ RowPair load_pair(
    int p, const int32_t* la_, const int32_t* lb_, const int32_t* lw_,
    const int32_t* up_, const float* u_, const float* v_, const float* tg_,
    const uint8_t* exg_) {
  RowPair q;
  q.La = la_[p];
  q.Lb = lb_[p];
  q.LW = lw_[p];
  q.UP = up_[p];
  q.u = u_[p];
  q.v = v_[p];
  const float tg = tg_[p];
  q.fa_l = exg_[4 * p + 0] ? 0.0f : tg;
  q.fa_r = exg_[4 * p + 1] ? 0.0f : tg;
  q.fb_l = exg_[4 * p + 2] ? 0.0f : tg;
  q.fb_r = exg_[4 * p + 3] ? 0.0f : tg;
  return q;
}

// H of lane j in the virtual boundary row m = -1 (lane j holds
// n = -1 + lw0 + j, readable only where slot n + 1 lies in the band)
__device__ __forceinline__ float boundary_h(const RowPair& q, int j, int lw0,
                                            int W) {
  const int nv = lw0 - 1 + j, r = lw0 + j;
  if (j >= W) return kNegSent;
  if (nv == -1) return 0.0f;
  if (nv >= 0 && r >= q.LW && r <= q.UP)
    return -(q.v + (float)(nv + 1) * q.u) * q.fa_l;
  return kNegSent;
}

// H of lane j after row m from its value before the band mask: inside
// the band and the pair it stays, at n == -1 it is the left column's
// value while that is open, else NEG_SENT
__device__ __forceinline__ float mask_lane(float h, const RowPair& q, int j,
                                           int m, int lw0, int W, float colb,
                                           bool colb_ok) {
  const int n = m + lw0 + j, r = lw0 + j;
  if (n >= 0 && n < q.Lb && r >= q.LW && r <= q.UP) return h;
  return (n == -1 && colb_ok && j < W) ? colb : kNegSent;
}

// Pass 1 of a row over a thread's L lanes: X, the new G, the in-thread
// running maximum P of C + j*u, and Y = max(X, P - j*u) in the place of
// H.  COLB: the left column is open (lane rz opens its gap from it); PAD:
// the lanes from rW on keep G at NEVSEL.  Returns P of the last lane.
template <int L, bool COLB, bool PAD>
__device__ __forceinline__ float row_pass1(
    float (&H)[L], float (&G)[L], const float (&ju)[L], const int (&cd)[L],
    const float* srow, float hs, float gs, float x_last, float xprev,
    float u, float v, int rz, float colc, int rW) {
  float run = kNevsel;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const float hn = i < L - 1 ? H[i + 1] : hs;
    const float gn = i < L - 1 ? G[i + 1] : gs;
    const float g0 = fmaxf(hn - v, gn) - u;
    const float x = i < L - 1 ? fmaxf(H[i] + srow[cd[i]], g0) : x_last;
    float c = (xprev - v) - u;
    if (COLB) c = i == rz ? colc : c;
    run = fmaxf(run, c + ju[i]);
    H[i] = fmaxf(x, run - ju[i]);
    G[i] = PAD && i >= rW ? kNevsel : g0;
    xprev = x;
  }
  return run;
}

// Pass 2: H = max(Y, carry - j*u) inside the band [lo, hi], the left
// column's value at lane rv while it is open (COLB), NEG_SENT elsewhere.
// BCOL: returns H of lane rb (the right column).
template <int L, bool COLB, bool BCOL>
__device__ __forceinline__ float row_pass2(float (&H)[L],
                                           const float (&ju)[L], float carry,
                                           int lo, int hi, int rv, float colb,
                                           int rb) {
  float bsel = kNegSent;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    float h = fmaxf(H[i], carry - ju[i]);
    h = (i >= lo && i <= hi) ? h : (COLB && i == rv ? colb : kNegSent);
    if (BCOL) bsel = i == rb ? h : bsel;
    H[i] = h;
  }
  return bsel;
}

// The register-state kernel.  WARPS = false: the "warp" variant (warp w
// of a block sweeps pair blockIdx.x * (blockDim.x / 32) + w); WARPS =
// true: the "warps" variant (the block's warps sweep pair blockIdx.x
// together, L lanes a thread, 32 L a warp); CLUSTER (with WARPS): the
// "cluster" variant (the ``ctas`` CTAs of a cluster sweep pair
// blockIdx.x / ctas together, CTA r on the L blockDim.x lanes from
// r L blockDim.x).
template <int L, bool WARPS, bool CLUSTER>
__global__ void __launch_bounds__(WARPS ? 512 : 128) pairwise_rows_reg_kernel(
    const int32_t* __restrict__ a_batch, const int32_t* __restrict__ b_batch,
    const int32_t* __restrict__ la_, const int32_t* __restrict__ lb_,
    const int32_t* __restrict__ lw_, const int32_t* __restrict__ up_,
    const float* __restrict__ u_, const float* __restrict__ v_,
    const float* __restrict__ tg_, const uint8_t* __restrict__ exg_,
    const float* __restrict__ mtx, float* __restrict__ out, int B, int Ma,
    int Mb, int dim, int lw0, int W, int code_stride, int ctas) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ms = dim + 1;                    // matrix row stride
  float* smtx = reinterpret_cast<float*>(smem);
  // warps variant: edges[2][nwarps][5] and red[3][nwarps] after the matrix;
  // cluster variant: then the slots the other CTAs push into, [2][20] by
  // row parity (the CTAs' totals by rank, the next CTA's first lane's Y
  // and G, the previous CTA's last lane's Y and carry), and the CTAs' end
  // maxima [3][16]
  float* edges = smtx + dim * ms;
  float* red = edges + 10 * nwarps;
  float* xs = red + 3 * nwarps;
  float* cred = xs + (CLUSTER ? 40 : 0);
  uint8_t* codes = reinterpret_cast<uint8_t*>(CLUSTER ? cred + 48 : xs);
  const int npairs = WARPS ? 1 : nwarps;     // pairs of this block
  const int rank = CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const int pb = CLUSTER ? blockIdx.x / ctas : blockIdx.x;
  const bool last_cta = !CLUSTER || rank == ctas - 1;

  for (int i = threadIdx.x; i < dim * ms; i += blockDim.x) {
    const int r = i / ms, c = i - r * ms;
    smtx[i] = c < dim ? mtx[r * dim + c] : 0.0f;
  }
  for (int k = 0; k < npairs; ++k) {
    const int p = WARPS ? pb : pb * nwarps + k;
    if (p >= B) break;
    uint8_t* ca = codes + (size_t)k * code_stride;
    uint8_t* cb = ca + Ma;
    const int La = min(la_[p], Ma);
    for (int i = threadIdx.x; i < La; i += blockDim.x)
      ca[i] = (uint8_t)a_batch[(size_t)p * Ma + i];
    for (int i = threadIdx.x; i < Mb; i += blockDim.x)
      cb[i] = (uint8_t)b_batch[(size_t)p * Mb + i];
  }
  __syncthreads();

  const int p = WARPS ? pb : pb * nwarps + warp;
  if (p >= B) return;
  const uint8_t* sa = codes + (size_t)(WARPS ? 0 : warp) * code_stride;
  const uint8_t* sb = sa + Ma;
  const RowPair q = load_pair(p, la_, lb_, lw_, up_, u_, v_, tg_, exg_);
  // thread within the pair
  const int gt = WARPS ? rank * (int)blockDim.x + (int)threadIdx.x : lane;
  const int j0 = gt * L;
  const float u = q.u, v = q.v;
  // (the same for every thread of a pair, so a warps block, and a
  // cluster, leaves whole)
  if (q.La <= 0 || q.La > Ma || q.LW < lw0 || q.UP - lw0 >= W) {
    // no row ever becomes the last row, or the band lies outside the
    // packing the launch was given: NEVSEL as the plain version, NaN
    if (gt == 0) out[p] = q.La <= 0 ? kNevsel : nanf("");
    return;
  }

  float H[L], G[L], ju[L];
  int cd[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int j = j0 + i;
    ju[i] = (float)j * u;
    H[i] = boundary_h(q, j, lw0, W);
    G[i] = kNevsel;
    const int n = lw0 + j;
    cd[i] = (n >= 0 && n < Mb) ? sb[n] : dim;
  }
  // warps variant: lane 0 keeps H of the lane left of j0 and its code,
  // lane 31 H and G of the lane right of its last (previous row)
  float hL = kNegSent, hF = kNegSent, gF = kNevsel;
  int cdl = dim;
  if (WARPS && lane == 0 && gt > 0) {
    hL = boundary_h(q, j0 - 1, lw0, W);
    const int n = lw0 + j0 - 1;
    cdl = (n >= 0 && n < Mb) ? sb[n] : dim;
  }
  if (WARPS && lane == 31 && (warp < nwarps - 1 || !last_cta))
    hF = boundary_h(q, j0 + L, lw0, W);
  // the cluster variant: every CTA of the cluster running before any
  // pushes into another
  if (CLUSTER) {
    cluster_arrive();
    cluster_wait();
  }

  float bcol = kNevsel;              // right-column terminal candidates
  // the score reads them only with a free right end of b
  const bool bcol_on = q.fb_r < 1.0f;
  // lanes past W keep G at NEVSEL, as the plain version's missing lanes;
  // for u >= 0 their G, (NEG_SENT - v) - u at most, never beats the
  // NEG_SENT - v of lane W - 1's vertical opening, so it needs no mask
  const bool force_pad = !(u >= 0.0f);
  for (int m = 0; m < q.La; ++m) {
    const float mf = (float)m;
    const float* srow = smtx + (int)sa[m] * ms;
    const float colb = -(v + (mf + 1.0f) * u) * q.fb_l;   // H(m, -1)
    const bool colb_ok = m < -q.LW;
    const int base = m + lw0;        // column of lane 0
    // the lanes, relative to j0, that the row treats apart: the band
    // [lo, hi], the left column's lane (n == -1), the lane that opens its
    // gap from the left column (n == 0), the right column's (n == Lb - 1)
    // and the first lane past the batch's W
    const int lo = max(q.LW - lw0, -base) - j0;
    const int hi = min(q.UP - lw0, q.Lb - 1 - base) - j0;
    const int rv = (colb_ok && -1 - base < W) ? -1 - base - j0 : -kFar;
    const int rz = colb_ok ? -base - j0 : -kFar;
    const int jb = q.Lb - 1 - base;
    const int rb = jb < W ? jb - j0 : -kFar;
    const int rW = W - j0;
    const float colc = (colb - v) - u;

    // the next lane's H and G of the previous row, past the thread's last
    float hs = __shfl_down_sync(kFull, H[0], 1);
    float gs = __shfl_down_sync(kFull, G[0], 1);
    if (lane == 31) {
      hs = hF;
      gs = gF;
    }
    // X of the thread's last lane first: the next thread reads it
    const float x_last =
        fmaxf(H[L - 1] + srow[cd[L - 1]], fmaxf(hs - v, gs) - u);
    float xprev = __shfl_up_sync(kFull, x_last, 1);
    if (lane == 0) {
      // warps variant: X of the previous warp's last lane, recomputed
      xprev = (WARPS && gt > 0)
                  ? fmaxf(hL + srow[cdl], fmaxf(H[0] - v, G[0]) - u)
                  : kNegSent;
    }

    // pass 1, in the form the row needs (the branches are the same for
    // every thread of the pair)
    float run;
    if (colb_ok)
      run = force_pad ? row_pass1<L, true, true>(H, G, ju, cd, srow, hs, gs,
                                                 x_last, xprev, u, v, rz,
                                                 colc, rW)
                      : row_pass1<L, true, false>(H, G, ju, cd, srow, hs, gs,
                                                  x_last, xprev, u, v, rz,
                                                  colc, rW);
    else
      run = force_pad ? row_pass1<L, false, true>(H, G, ju, cd, srow, hs, gs,
                                                  x_last, xprev, u, v, rz,
                                                  colc, rW)
                      : row_pass1<L, false, false>(H, G, ju, cd, srow, hs, gs,
                                                   x_last, xprev, u, v, rz,
                                                   colc, rW);

    // the carry from the threads (and warps) to the left
    const float incl = warp_cummax(run, lane);
    float carry = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) carry = kNevsel;
    if (WARPS) {
      // slots of this row: the warps' totals, first lanes' Y and G, last
      // lanes' Y and in-warp carry, nwarps words each
      float* eb = edges + 5 * nwarps * (m & 1);
      if (lane == 0) {
        eb[nwarps + warp] = H[0];
        eb[2 * nwarps + warp] = G[0];
      }
      if (lane == 31) {
        eb[warp] = incl;
        eb[3 * nwarps + warp] = H[L - 1];
        eb[4 * nwarps + warp] = carry;
      }
      named_sync(blockDim.x);
      // the running maxima of the totals into warps warp - 1, warp and
      // warp + 1 (each word a broadcast read)
      float c_prev = kNevsel, c_in = kNevsel, c_next = kNevsel;
      for (int k = 0; k <= warp; ++k) {
        const float t = eb[k];
        c_prev = k < warp - 1 ? fmaxf(c_prev, t) : c_prev;
        c_in = k < warp ? fmaxf(c_in, t) : c_in;
        c_next = fmaxf(c_next, t);
      }
      carry = fmaxf(carry, c_in);
      float yF = 0.0f, yL = 0.0f, cL = 0.0f;
      if (CLUSTER) {
        // this row's slots: the CTA's total into the CTAs to its right
        // (the last warp's c_next: the maximum over the CTA's warps), its
        // last lane's Y and carry into the next CTA, its first lane's Y
        // and new G into the previous one; meet; fold in the totals of
        // the CTAs to the left
        float* xb = xs + 20 * (m & 1);
        cg::cluster_group cluster = cg::this_cluster();
        if (warp == nwarps - 1) {
          if (lane > rank && lane < ctas)
            cluster.map_shared_rank(xb, lane)[rank] = c_next;
          if (lane == 31 && !last_cta) {
            float* nx = cluster.map_shared_rank(xb, rank + 1);
            nx[18] = H[L - 1];
            nx[19] = carry;
          }
        }
        if (warp == 0 && lane == 0 && rank > 0) {
          float* pv = cluster.map_shared_rank(xb, rank - 1);
          pv[16] = H[0];
          pv[17] = G[0];
        }
        cluster_arrive();
        cluster_wait();
        const float t2 = warp_max(lane < rank - 1 ? xb[lane] : kNevsel);
        const float tl = rank > 0 ? fmaxf(t2, xb[rank - 1]) : kNevsel;
        carry = fmaxf(carry, tl);
        c_next = fmaxf(c_next, tl);
        c_prev = fmaxf(c_prev, tl);
        if (warp == nwarps - 1 && lane == 31 && !last_cta) {
          yF = xb[16];
          gF = xb[17];
        }
        if (warp == 0 && lane == 0 && rank > 0) {
          yL = xb[18];
          cL = fmaxf(t2, xb[19]);
        }
      }
      // the neighbouring warps' edge lanes of this row, for the next row
      // (the cluster variant: across a CTA edge, from the slots)
      if (lane == 31 && (warp < nwarps - 1 || !last_cta)) {
        const int jF = j0 + L;
        const bool here = !CLUSTER || warp < nwarps - 1;
        hF = mask_lane(fmaxf(here ? eb[nwarps + warp + 1] : yF,
                             c_next - (float)jF * u),
                       q, jF, m, lw0, W, colb, colb_ok);
        if (here) gF = eb[2 * nwarps + warp + 1];
      }
      if (lane == 0 && (warp > 0 || (CLUSTER && rank > 0))) {
        const int jL = j0 - 1;
        const bool here = !CLUSTER || warp > 0;
        const float cl = here ? fmaxf(c_prev, eb[4 * nwarps + warp - 1]) : cL;
        hL = mask_lane(fmaxf(here ? eb[3 * nwarps + warp - 1] : yL,
                             cl - (float)jL * u),
                       q, jL, m, lw0, W, colb, colb_ok);
      }
    }

    // pass 2: fold in the carry, mask the band, and keep the right
    // column's value where the score reads it
    if (bcol_on && m < q.La - 1) {
      const float bsel = colb_ok
          ? row_pass2<L, true, true>(H, ju, carry, lo, hi, rv, colb, rb)
          : row_pass2<L, false, true>(H, ju, carry, lo, hi, rv, colb, rb);
      if (rb >= 0 && rb < L)
        bcol = fmaxf(bcol, bsel - (v + (float)(q.La - 1 - m) * u) * q.fb_r);
    } else if (colb_ok) {
      row_pass2<L, true, false>(H, ju, carry, lo, hi, rv, colb, rb);
    } else {
      row_pass2<L, false, false>(H, ju, carry, lo, hi, rv, colb, rb);
    }

    // the code window moves one column to the right
    if (WARPS) cdl = cd[0];
#pragma unroll
    for (int i = 0; i < L - 1; ++i) cd[i] = cd[i + 1];
    const int nn = base + 1 + j0 + L - 1;
    cd[L - 1] = (nn >= 0 && nn < Mb) ? sb[nn] : dim;
  }

  // finish: H is the last row.  Corner, last-row and right-column
  // maxima with the terminal-gap factors
  float corner = kNevsel, brow = kNevsel;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int j = j0 + i;
    const int n_last = q.La - 1 + lw0 + j;
    const int kfb = q.Lb - 1 - n_last;
    if (j < W && kfb == 0) corner = fmaxf(corner, H[i]);
    if (j < W && kfb > 0 && n_last >= 0)
      brow = fmaxf(brow, H[i] - (v + (float)kfb * u) * q.fa_r);
  }
  corner = warp_max(corner);
  brow = warp_max(brow);
  bcol = warp_max(bcol);
  if (WARPS) {
    if (lane == 0) {
      red[warp] = corner;
      red[nwarps + warp] = brow;
      red[2 * nwarps + warp] = bcol;
    }
    named_sync(blockDim.x);
    if (threadIdx.x == 0) {
      for (int w = 1; w < nwarps; ++w) {
        corner = fmaxf(corner, red[w]);
        brow = fmaxf(brow, red[nwarps + w]);
        bcol = fmaxf(bcol, red[2 * nwarps + w]);
      }
    }
  }
  if (CLUSTER) {
    // the CTAs' maxima into CTA 0's shared memory; maxima are exact in
    // any order
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      float* c0 = cluster.map_shared_rank(cred, 0);
      c0[rank] = corner;
      c0[16 + rank] = brow;
      c0[32 + rank] = bcol;
    }
    cluster_arrive();
    cluster_wait();
    if (gt == 0)
      for (int r = 1; r < ctas; ++r) {
        corner = fmaxf(corner, cred[r]);
        brow = fmaxf(brow, cred[16 + r]);
        bcol = fmaxf(bcol, cred[32 + r]);
      }
  }
  if (gt == 0) {
    float score = corner;
    if (q.fa_r < 1.0f) score = fmaxf(score, brow);
    if (q.fb_r < 1.0f) score = fmaxf(score, bcol);
    out[p] = score;
  }
}

// the maximum over a block (block variant)
__device__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_down_sync(kFull, x, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < (int)(blockDim.x >> 5) ? red[lane] : kNevsel;
    for (int off = 16; off > 0; off >>= 1)
      x = fmaxf(x, __shfl_down_sync(kFull, x, off));
    if (lane == 0) red[0] = x;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

// bytes of a pair's row and codes in the device-memory block variant
__host__ __device__ __forceinline__ size_t rows_state_bytes(int W, int Ma,
                                                            int Mb) {
  return ((size_t)20 * W + Ma + Mb + 15) / 16 * 16;
}

// The "block" variant, the first design: one thread block per pair, L
// adjacent lanes a thread (L = 1 up to 1,024 lanes).  Step 1 of a row
// reads the previous row's H and G from shared memory and forms X, the
// new G and the thread's running maximum of C + j*u; a thread recomputes
// X of the lane left of its own instead of waiting for its neighbour.
// Warp shuffles scan the threads' maxima, one word per warp crosses
// through shared memory (barrier 1), then step 2 folds the carries in,
// masks the band and writes H and G in place (barrier 2).  The last row
// is the loop's final H; the right-column candidates are a running
// maximum in the one thread that holds column lb - 1.  DEV: the row
// (five arrays of W lanes) and the codes in device memory (``state``,
// 5 W floats and Ma + Mb bytes a pair, 16-byte aligned), and the matrix
// too where ``mtx_shared`` is 0, for rows that shared memory does not
// hold; the block barriers order the block's device-memory writes
// before its reads as they do its shared ones.
template <bool DEV>
__global__ void pairwise_rows_block_kernel(
    const int32_t* __restrict__ a_batch, const int32_t* __restrict__ b_batch,
    const int32_t* __restrict__ la_, const int32_t* __restrict__ lb_,
    const int32_t* __restrict__ lw_, const int32_t* __restrict__ up_,
    const float* __restrict__ u_, const float* __restrict__ v_,
    const float* __restrict__ tg_, const uint8_t* __restrict__ exg_,
    const float* __restrict__ mtx, float* __restrict__ out,
    int Ma, int Mb, int dim, int lw0, int W, int L, unsigned char* state,
    int mtx_shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarp = blockDim.x >> 5;
  const int La = la_[p], Lb = lb_[p], LW = lw_[p], UP = up_[p];
  const float u = u_[p], v = v_[p], tgapf = tg_[p];
  const float fa_l = exg_[4 * p + 0] ? 0.0f : tgapf;
  const float fa_r = exg_[4 * p + 1] ? 0.0f : tgapf;
  const float fb_l = exg_[4 * p + 2] ? 0.0f : tgapf;
  const float fb_r = exg_[4 * p + 3] ? 0.0f : tgapf;
  if (La <= 0 || La > Ma || LW < lw0 || UP - lw0 >= W) {
    // as the register variants: NEVSEL with no row, NaN outside the
    // packing
    if (tid == 0) out[p] = La <= 0 ? kNevsel : nanf("");
    return;
  }

  float* smtx = reinterpret_cast<float*>(smem);   // dim * dim
  // the device variant's pair: its row and codes in ``state``
  float* dst = DEV ? reinterpret_cast<float*>(
                         state + (size_t)p * rows_state_bytes(W, Ma, Mb))
                   : nullptr;
  float* H = DEV ? dst : smtx + dim * dim;   // previous row, W lanes each
  float* G = H + W;
  float* Xs = G + W;                 // this row's X, new G, running max
  float* Gn = Xs + W;
  float* Ts = Gn + W;
  // one carry per warp (32 words)
  float* wtot = DEV ? smtx + (mtx_shared ? dim * dim : 0) : Ts + W;
  // the pair's b codes, Mb bytes, then its a codes, Ma bytes
  uint8_t* bc = (uint8_t*)(DEV ? Ts + W : wtot + 32);
  uint8_t* ac = bc + Mb;

  if (DEV && !mtx_shared)
    smtx = const_cast<float*>(mtx);
  else
    for (int i = tid; i < dim * dim; i += blockDim.x) smtx[i] = mtx[i];
  for (int i = tid; i < Mb; i += blockDim.x)
    bc[i] = (uint8_t)b_batch[(size_t)p * Mb + i];
  for (int i = tid; i < Ma; i += blockDim.x)
    ac[i] = (uint8_t)a_batch[(size_t)p * Ma + i];
  // virtual boundary row m = -1: lane j holds n = -1 + lw0 + j, and its
  // value is readable only where slot n + 1 lies inside the band
  for (int j = tid; j < W; j += blockDim.x) {
    const int nv = lw0 - 1 + j;
    const int r = lw0 + j;
    float h = kNegSent;
    if (nv == -1) h = 0.0f;
    else if (nv >= 0 && r >= LW && r <= UP)
      h = -(v + (float)(nv + 1) * u) * fa_l;
    H[j] = h;
    G[j] = kNevsel;
  }
  __syncthreads();

  const int j0 = tid * L;
  const int j1 = min(j0 + L, W);
  float bcol = kNevsel;              // right-column terminal candidates
  for (int m = 0; m < La; ++m) {
    const float mf = (float)m;
    const float* srow = smtx + (int)ac[m] * dim;
    const float colb = -(v + (mf + 1.0f) * u) * fb_l;   // H(m, -1)
    const bool colb_ok = m < -LW;
    const int n0 = m + lw0;          // column of lane 0

    // step 1: X, the new G and the running maximum of C + j*u
    float run = kNevsel;
    if (j0 < W) {
      float xprev = kNegSent;        // X of the lane left of j0
      if (j0 > 0) {
        const int j = j0 - 1, n = n0 + j;
        const float s = (n >= 0 && n < Mb) ? srow[bc[n]] : 0.0f;
        const float g0 = fmaxf(H[j0] - v, G[j0]) - u;
        xprev = fmaxf(H[j] + s, g0);
      }
      for (int j = j0; j < j1; ++j) {
        const int n = n0 + j;
        const float s = (n >= 0 && n < Mb) ? srow[bc[n]] : 0.0f;
        const float hs = j + 1 < W ? H[j + 1] : kNegSent;
        const float gs = j + 1 < W ? G[j + 1] : kNevsel;
        const float g0 = fmaxf(hs - v, gs) - u;
        const float x = fmaxf(H[j] + s, g0);
        float c = (xprev - v) - u;
        // the n == 0 lane opens its horizontal gap from the left column
        if (n == 0 && colb_ok) c = (colb - v) - u;
        run = fmaxf(run, c + (float)j * u);
        Xs[j] = x;
        Gn[j] = g0;
        Ts[j] = run;
        xprev = x;
      }
    }
    const float incl = warp_cummax(run, lane);
    float carry = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) carry = kNevsel;
    if (lane == 31) wtot[warp] = incl;
    __syncthreads();

    // step 2: fold in the carries of the warps to the left, finish H
    const float wsum = warp_cummax(lane < nwarp ? wtot[lane] : kNevsel, lane);
    const float wcarry = __shfl_sync(kFull, wsum, warp > 0 ? warp - 1 : 0);
    if (warp > 0) carry = fmaxf(carry, wcarry);
    for (int j = j0; j < j1; ++j) {
      const int n = n0 + j, r = lw0 + j;
      const float e = fmaxf(Ts[j], carry) - (float)j * u;
      float h0 = fmaxf(Xs[j], e);
      const bool valid = n >= 0 && n < Lb && r >= LW && r <= UP;
      if (!valid) h0 = (n == -1 && colb_ok) ? colb : kNegSent;
      H[j] = h0;
      G[j] = Gn[j];
      if (n == Lb - 1 && m < La - 1) {
        const float kb = (float)(La - 1) - mf;
        bcol = fmaxf(bcol, h0 - (v + kb * u) * fb_r);
      }
    }
    __syncthreads();
  }

  // finish: H is the last row.  Corner, last-row and right-column
  // maxima with the terminal-gap factors
  float corner = kNevsel, brow = kNevsel;
  for (int j = tid; j < W; j += blockDim.x) {
    const int n_last = La - 1 + lw0 + j;
    const int kfb = Lb - 1 - n_last;
    if (kfb == 0) corner = fmaxf(corner, H[j]);
    if (kfb > 0 && n_last >= 0)
      brow = fmaxf(brow, H[j] - (v + (float)kfb * u) * fa_r);
  }
  float score = block_max(corner, wtot);
  brow = block_max(brow, wtot);
  bcol = block_max(bcol, wtot);
  if (fa_r < 1.0f) score = fmaxf(score, brow);
  if (fb_r < 1.0f) score = fmaxf(score, bcol);
  if (tid == 0) out[p] = score;
}

using RowsKernel = void (*)(const int32_t*, const int32_t*, const int32_t*,
                            const int32_t*, const int32_t*, const int32_t*,
                            const float*, const float*, const float*,
                            const uint8_t*, const float*, float*, int, int,
                            int, int, int, int, int, int);

template <bool CLUSTER>
RowsKernel warps_kernel(int lanes) {
  switch (lanes) {
    case 4: return pairwise_rows_reg_kernel<4, true, CLUSTER>;
    case 8: return pairwise_rows_reg_kernel<8, true, CLUSTER>;
    case 12: return pairwise_rows_reg_kernel<12, true, CLUSTER>;
    case 16: return pairwise_rows_reg_kernel<16, true, CLUSTER>;
  }
  return nullptr;
}

// the register-state kernel of a variant (1: warp, 2: warps, 3:
// cluster), or null
RowsKernel pick_kernel(int variant, int lanes) {
  if (variant == 1) {
    switch (lanes) {
      case 2: return pairwise_rows_reg_kernel<2, false, false>;
      case 4: return pairwise_rows_reg_kernel<4, false, false>;
      case 8: return pairwise_rows_reg_kernel<8, false, false>;
      case 12: return pairwise_rows_reg_kernel<12, false, false>;
      case 16: return pairwise_rows_reg_kernel<16, false, false>;
      case 20: return pairwise_rows_reg_kernel<20, false, false>;
      case 24: return pairwise_rows_reg_kernel<24, false, false>;
      case 28: return pairwise_rows_reg_kernel<28, false, false>;
      case 32: return pairwise_rows_reg_kernel<32, false, false>;
    }
  }
  if (variant == 2) return warps_kernel<false>(lanes);
  if (variant == 3) return warps_kernel<true>(lanes);
  return nullptr;
}

}  // namespace

// variant 0: block (L = ceil(W / 1024) lanes a thread, threads and
// code_stride ignored; ``state`` null: the row and codes in shared
// memory, else in ``state``, rows_state_bytes a pair, and the matrix in
// shared memory where smem_bytes holds it); 1: warp (threads / 32 pairs
// a block); 2: warps (threads / 32 warps a pair); 3: cluster (ctas CTAs
// of threads / 32 warps a pair).  lanes: lanes a thread of the register
// variants; code_stride: bytes of a pair's codes in shared memory.
extern "C" int pairwise_rows_launch(
    const void* a_batch, const void* b_batch, const void* la, const void* lb,
    const void* lw, const void* up, const void* u, const void* v,
    const void* tgapf, const void* exg, const void* mtx, void* out,
    void* state, int B, int Ma, int Mb, int dim, int lw0, int W,
    int variant, int lanes, int threads, int code_stride, int smem_bytes,
    int ctas, void* stream) {
  const int32_t* a = (const int32_t*)a_batch;
  const int32_t* b = (const int32_t*)b_batch;
  const int32_t *la_ = (const int32_t*)la, *lb_ = (const int32_t*)lb;
  const int32_t *lw_ = (const int32_t*)lw, *up_ = (const int32_t*)up;
  const float *u_ = (const float*)u, *v_ = (const float*)v;
  const float* tg_ = (const float*)tgapf;
  const uint8_t* exg_ = (const uint8_t*)exg;
  const float* mtx_ = (const float*)mtx;
  float* out_ = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  if (W < 1 || dim > 256 || B < 1) return (int)cudaErrorInvalidValue;
  if (variant == 0) {
    // L adjacent lanes a thread, threads a multiple of the warp
    const int L = (W + 1023) / 1024;
    const int nthreads = (((W + L - 1) / L + 31) / 32) * 32;
    if (state == nullptr) {
      const size_t smem =
          sizeof(float) * ((size_t)dim * dim + 5 * (size_t)W + 32) +
          (size_t)Mb + (size_t)Ma;
      cudaError_t err = cudaFuncSetAttribute(
          pairwise_rows_block_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      pairwise_rows_block_kernel<false><<<B, nthreads, smem, st>>>(
          a, b, la_, lb_, lw_, up_, u_, v_, tg_, exg_, mtx_, out_, Ma, Mb,
          dim, lw0, W, L, nullptr, 1);
      return (int)cudaGetLastError();
    }
    // the row and codes in device memory; the matrix in shared memory
    // where smem_bytes holds it
    const int mtx_shared =
        (size_t)smem_bytes >= sizeof(float) * ((size_t)dim * dim + 32);
    if (smem_bytes < (int)(32 * sizeof(float))) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        pairwise_rows_block_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    pairwise_rows_block_kernel<true><<<B, nthreads, smem_bytes, st>>>(
        a, b, la_, lb_, lw_, up_, u_, v_, tg_, exg_, mtx_, out_, Ma, Mb, dim,
        lw0, W, L, (unsigned char*)state, mtx_shared);
    return (int)cudaGetLastError();
  }
  const RowsKernel kern = pick_kernel(variant, lanes);
  const int nw = threads / 32;
  if (kern == nullptr || threads < 32 || threads % 32 != 0 || dim > 255 ||
      (variant == 1 && (threads > 128 || 32 * lanes < W)) ||
      (variant == 2 && (threads > 512 || 32 * lanes * nw < W)) ||
      (variant == 3 && (threads > 512 || ctas < 2 || ctas > 16 ||
                        32 * lanes * nw * ctas < W)) ||
      code_stride < Ma + Mb)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (variant == 3) {
    // B clusters of ctas CTAs; refused where the card holds no such
    // cluster (16 CTAs is a non-portable size)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * ctas, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = ctas;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    bool fits = false;
    err = prrn_kernels::cluster_fits((const void*)kern, cfg, &fits);
    if (err != cudaSuccess) return (int)err;
    if (!fits) return (int)cudaErrorInvalidConfiguration;
    err = cudaLaunchKernelEx(&cfg, kern, a, b, la_, lb_, lw_, up_, u_, v_,
                             tg_, exg_, mtx_, out_, B, Ma, Mb, dim, lw0, W,
                             code_stride, ctas);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const int per_block = variant == 1 ? nw : 1;
  kern<<<(B + per_block - 1) / per_block, threads, smem_bytes, st>>>(
      a, b, la_, lb_, lw_, up_, u_, v_, tg_, exg_, mtx_, out_, B, Ma, Mb, dim,
      lw0, W, code_stride, 1);
  return (int)cudaGetLastError();
}

// registers a thread and local (spilled) bytes of a variant's kernel
// (variant 0: the block variant with its row in shared memory; 4: in
// device memory; 1-3: the register variants as pairwise_rows_launch)
extern "C" int pairwise_rows_attrs(int variant, int lanes, void* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      variant == 0   ? cudaFuncGetAttributes(&attr, pairwise_rows_block_kernel<false>)
      : variant == 4 ? cudaFuncGetAttributes(&attr, pairwise_rows_block_kernel<true>)
      : pick_kernel(variant, lanes) == nullptr
          ? cudaErrorInvalidValue
          : cudaFuncGetAttributes(&attr, pick_kernel(variant, lanes));
  if (err != cudaSuccess) return (int)err;
  ((int*)out)[0] = attr.numRegs;
  ((int*)out)[1] = (int)attr.localSizeBytes;
  return 0;
}
