// Kernel K1: batched banded affine-gap (Gotoh) DP, score only.
//
// Replaces prrn_aln_tpu/ops/pallas_pairwise.py::_kernel_rows (the TPU
// row sweep launched by _launch / pallas_pairwise_scores).  Its plain
// PyTorch version is ops/pairwise.py::wavefront_scores_ref, a
// transcription of prrn_aln_tpu/ops/pairwise.py::wavefront_scores; this
// kernel runs the same recurrence with the same f32 operations in the
// same order (built with -fmad=false), so the scores are equal.
//
// What bounds it on the card: the serial anti-diagonal chain.  A pair of
// lengths La x Lb takes La + Lb - 1 dependent steps, and a step touches
// only the band slots of its parity (slot k holds diagonal r = lw - 1 +
// k, and step d updates the slots with d - r even), each reading its two
// neighbours of the other parity.  Device-memory traffic is tiny: the two
// code rows and the matrix.  So a step's latency sets the pace.
//
// What the design does about it: the band state lives in registers.  A
// lane owns L adjacent slot pairs (2L slots: L of each parity) and keeps
// their H, F and G; at a step it updates only its L slots of the step's
// parity, and reads the neighbour slot past each end of its range from
// the adjacent lane with one warp shuffle.  The codes are bytes in shared
// memory beside the matrix; a step's substitution scores are loaded at
// its start, every load made (indices clamped, no branch), so that they
// run beside the shuffles.
//
// Variants (ops/pairwise.py::pairwise_plan chooses by band width):
// "warp", one warp a pair and several pairs a block, with no barrier in
// the step loop; "warps", several warps a pair (one pair a block) that
// pass their edge slots through a two-step ring in shared memory and
// meet at a named barrier each step; "cluster", the "warps" variant's
// layout on each CTA of a thread-block cluster of up to 16 a pair, for
// bands wider than one CTA's registers hold (10,240 slots); "block", the
// earlier design (the band state in shared memory, one block-wide
// barrier a step), and past what one cluster holds, or when asked for,
// the same with the band state in device memory.
//
// The cluster variant.  CTA r of P holds a window of 64 L W slots (W
// warps) from slot r O - G: its own O = 64 L W - 2 G slots and G ghost
// slots each side (G = 2 L gl, gl whole lanes), the neighbours' edge
// slots, which it computes too.  A window's edge slot reads the band's
// boundary value past the window, so a wrong value can enter there and
// moves in by at most one slot a step: after ``every`` <= G steps the
// owned slots are still exact.  Then the CTAs exchange: each pushes its
// first and last G owned slots (H, F, G of both parities) into its
// neighbours' ghost buffers through distributed shared memory, all take
// the cluster barrier (arrive.release, wait.acquire), and each ghost
// lane loads its slots from its own buffer.  The buffers alternate by
// exchange, so a push is never over one a neighbour still reads: it
// read that buffer before its next arrive, which the pusher waited for.
// One cluster barrier every ``every`` steps instead of every step: a
// barrier costs ~0.7 us (K2's barrier chain on 7-16 CTAs), a step of the
// "warps" variant a fraction of that (a 20 kb DNA pair on 16 CTAs: 0.40
// us a step with an exchange every 16 steps, 1.17 with one every step,
// tools/k1k3_bench.py on an H100).  Only owned slots feed the score.
// The window's slots outside the band (below slot 0, past the band's
// last slot) hold the boundary values and never change, so CTA 0's low
// and CTA P - 1's high ghosts are exact and need no exchange.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_fits.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kNegSent = -1879048192.0f;   // -(2**31 // 8) * 7
constexpr float kNevsel = -1.0e30f;
constexpr int kBlockThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Pair {
  int La, Lb, LW, UP, W;
  float u, v, tgapf;
  bool exg0, exg1, exg2, exg3;
};

__device__ __forceinline__ Pair load_pair(
    int p, const int32_t* la_, const int32_t* lb_, const int32_t* lw_,
    const int32_t* up_, const float* u_, const float* v_, const float* tg_,
    const uint8_t* exg_) {
  Pair q;
  q.La = la_[p];
  q.Lb = lb_[p];
  q.LW = lw_[p];
  q.UP = up_[p];
  q.W = q.UP - q.LW + 3;           // slots lw-1 .. up+1
  q.u = u_[p];
  q.v = v_[p];
  q.tgapf = tg_[p];
  q.exg0 = exg_[4 * p + 0];
  q.exg1 = exg_[4 * p + 1];
  q.exg2 = exg_[4 * p + 2];
  q.exg3 = exg_[4 * p + 3];
  return q;
}

// boundary condition of slot k (fwd2d1.cc:66-89); past the band NEG_SENT
__device__ __forceinline__ float init_h(const Pair& q, int k) {
  const int r = q.LW - 1 + k;
  if (k >= q.W) return kNegSent;
  float h = 0.0f;
  if (r > 0 && !q.exg0) h = -(q.v + (float)r * q.u) * q.tgapf;
  if (r < 0 && !q.exg2) h = -(q.v - (float)r * q.u) * q.tgapf;
  if (r == q.LW - 1 || r == q.UP + 1) h = kNegSent;
  return h;
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

// The cluster variant's shape: CTAs a pair, ghost lanes a side, steps
// between exchanges, slots a CTA owns.
struct Ghost {
  int ctas, lanes, every, owned;
};

// The state a lane keeps: its slots k0 + 2i (even) and k0 + 2i + 1 (odd)
// for i < L, k0 = 2 L (global lane).
template <int L>
struct Band {
  float He[L], Fe[L], Ge[L], Ho[L], Fo[L], Go[L];
  // the steps d at which a slot lies in the DP (of its parity): lo .. hi
  int lo_e[L], hi_e[L], lo_o[L], hi_o[L];
};

// a lane's 6 L values to and from a ghost buffer slot
template <int L>
__device__ __forceinline__ void band_put(const Band<L>& st, float* g) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    g[i] = st.He[i];
    g[L + i] = st.Fe[i];
    g[2 * L + i] = st.Ge[i];
    g[3 * L + i] = st.Ho[i];
    g[4 * L + i] = st.Fo[i];
    g[5 * L + i] = st.Go[i];
  }
}

template <int L>
__device__ __forceinline__ void band_get(Band<L>& st, const float* g) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    st.He[i] = g[i];
    st.Fe[i] = g[L + i];
    st.Ge[i] = g[2 * L + i];
    st.Ho[i] = g[3 * L + i];
    st.Fo[i] = g[4 * L + i];
    st.Go[i] = g[5 * L + i];
  }
}

// A slot's steps in the DP: m = (d - r) / 2 in [0, La), n = (d + r) / 2
// in [0, Lb) and r in [lw, up]; an empty range (lo > hi) outside the band.
__device__ __forceinline__ void slot_steps(const Pair& q, int k, int& lo,
                                           int& hi) {
  const int r = q.LW - 1 + k;
  lo = abs(r);
  hi = min(r + 2 * q.La - 2, 2 * q.Lb - 2 - r);
  if (r < q.LW || r > q.UP) hi = -1;
}

// The scores of the slots of parity PK at step d, and which are valid.
// The codes' indices are clamped into the sequences, so every load is
// made (no branch) and an invalid slot's score is a score of no use.
template <int L, int PK>
__device__ __forceinline__ void load_scores(float (&s)[L], bool (&valid)[L],
                                            const Band<L>& st, const Pair& q,
                                            int k0, int d, const uint8_t* sa,
                                            const uint8_t* sb,
                                            const float* smtx, int dim) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int r = q.LW - 1 + k0 + 2 * i + PK;
    const int m = (d - r) >> 1;
    valid[i] = PK == 0 ? d >= st.lo_e[i] && d <= st.hi_e[i]
                       : d >= st.lo_o[i] && d <= st.hi_o[i];
    const int mc = min(max(m, 0), max(q.La - 1, 0));
    const int nc = min(max(m + r, 0), max(q.Lb - 1, 0));
    s[i] = smtx[sa[mc] * dim + sb[nc]];
  }
}

// One anti-diagonal step over the slots of parity PK.  (lo_h, lo_f) is
// the slot just below the lane's range (for PK = 0), (hi_h, hi_g) the
// slot just above it (for PK = 1).
template <int L, int PK, bool LOCAL>
__device__ __forceinline__ void band_step(Band<L>& st, const Pair& q,
                                          const float* s, const bool* valid,
                                          float lo_h, float lo_f, float hi_h,
                                          float hi_g, float& maxh) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    float h_lo, f_lo, h_hi, g_hi, h;
    if (PK == 0) {
      h_lo = i > 0 ? st.Ho[i - 1] : lo_h;
      f_lo = i > 0 ? st.Fo[i - 1] : lo_f;
      h_hi = st.Ho[i];
      g_hi = st.Go[i];
      h = st.He[i];
    } else {
      h_lo = st.He[i];
      f_lo = st.Fe[i];
      h_hi = i < L - 1 ? st.He[i + 1] : hi_h;
      g_hi = i < L - 1 ? st.Ge[i + 1] : hi_g;
      h = st.Ho[i];
    }
    const float f_new = fmaxf(h_lo - q.v, f_lo) - q.u;
    const float g_new = fmaxf(h_hi - q.v, g_hi) - q.u;
    float h_new = fmaxf(fmaxf(h + s[i], f_new), g_new);
    if (LOCAL) h_new = fmaxf(h_new, 0.0f);
    if (valid[i]) {
      if (LOCAL) maxh = fmaxf(maxh, h_new);
      if (PK == 0) {
        st.He[i] = h_new;
        st.Fe[i] = f_new;
        st.Ge[i] = g_new;
      } else {
        st.Ho[i] = h_new;
        st.Fo[i] = f_new;
        st.Go[i] = g_new;
      }
    }
  }
}

// The closed-form end of a global score (pairwise.py:108-121) over the
// lane's slots below nslot: (corner, last column, last row) maxima.
template <int L>
__device__ __forceinline__ void end_maxima(const Band<L>& st, const Pair& q,
                                           int k0, int nslot, float& best0,
                                           float& best_b, float& best_a) {
  const int r_end = q.Lb - q.La;
  const float f_b = q.exg3 ? 0.0f : q.tgapf;
  const float f_a = q.exg1 ? 0.0f : q.tgapf;
  const int hi_b = min(q.UP + 1, q.Lb);
  const int lo_a = max(q.LW - 1, -q.La + 1);
#pragma unroll
  for (int j = 0; j < 2 * L; ++j) {
    const int k = k0 + j;
    const float h = (j & 1) ? st.Ho[j >> 1] : st.He[j >> 1];
    const int r = q.LW - 1 + k;
    if (k >= nslot) continue;
    if (r == r_end) best0 = fmaxf(best0, h);
    if (r > r_end && r <= hi_b)
      best_b = fmaxf(best_b, h - f_b * (q.v + (float)(r - r_end) * q.u));
    if (r < r_end && r >= lo_a)
      best_a = fmaxf(best_a, h - f_a * (q.v + (float)(r_end - r) * q.u));
  }
}

__device__ __forceinline__ float final_score(const Pair& q, float best,
                                             float best_b, float best_a) {
  const float f_b = q.exg3 ? 0.0f : q.tgapf;
  const float f_a = q.exg1 ? 0.0f : q.tgapf;
  if (f_b < 1.0f) best = fmaxf(best, best_b);
  if (f_a < 1.0f) best = fmaxf(best, best_a);
  return best;
}

// Register-state kernel.  WARPS = 0: the "warp" variant (warp w of a
// block walks pair blockIdx.x * (blockDim.x / 32) + w); WARPS = 1: the
// "warps" variant (the block's warps walk pair blockIdx.x together);
// CLUSTER (with WARPS): the "cluster" variant (the gh.ctas CTAs of a
// cluster walk pair blockIdx.x / gh.ctas together, CTA r on its window).
template <int L, bool LOCAL, bool WARPS, bool CLUSTER>
__global__ void __launch_bounds__(512) pairwise_reg_kernel(
    const int32_t* __restrict__ a_batch, const int32_t* __restrict__ b_batch,
    const int32_t* __restrict__ la_, const int32_t* __restrict__ lb_,
    const int32_t* __restrict__ lw_, const int32_t* __restrict__ up_,
    const float* __restrict__ u_, const float* __restrict__ v_,
    const float* __restrict__ tg_, const uint8_t* __restrict__ exg_,
    const float* __restrict__ mtx, float* __restrict__ out, int B, int Ma,
    int Mb, int dim, int nslot, int code_stride, Ghost gh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  float* smtx = reinterpret_cast<float*>(smem);
  // warps variant: ring[2][nwarps][4] and red[3][nwarps] after the matrix;
  // cluster variant: then the ghost buffers [2][2][gh.lanes][6 L] (by
  // exchange, low and high side) and the CTAs' maxima [3][16]
  float* ring = smtx + dim * dim;
  float* red = ring + 8 * nwarps;
  float* ghost = red + 3 * nwarps;
  float* cred = ghost + (CLUSTER ? 24 * L * gh.lanes : 0);
  uint8_t* codes =
      reinterpret_cast<uint8_t*>(CLUSTER ? cred + 48 : ghost);
  const int npairs = WARPS ? 1 : nwarps;   // pairs of this block
  const int rank = CLUSTER ? (int)cg::this_cluster().block_rank() : 0;
  const int pb = CLUSTER ? blockIdx.x / gh.ctas : blockIdx.x;

  for (int i = threadIdx.x; i < dim * dim; i += blockDim.x) smtx[i] = mtx[i];
  for (int j = 0; j < npairs; ++j) {
    const int p = WARPS ? pb : pb * nwarps + j;
    if (p >= B) break;
    uint8_t* ca = codes + (size_t)j * code_stride;
    uint8_t* cb = ca + Ma;
    const int La = la_[p], Lb = lb_[p];
    for (int i = threadIdx.x; i < La; i += blockDim.x)
      ca[i] = (uint8_t)a_batch[(size_t)p * Ma + i];
    for (int i = threadIdx.x; i < Lb; i += blockDim.x)
      cb[i] = (uint8_t)b_batch[(size_t)p * Mb + i];
  }
  __syncthreads();

  const int p = WARPS ? pb : pb * nwarps + warp;
  if (p >= B) return;
  const uint8_t* sa = codes + (size_t)(WARPS ? 0 : warp) * code_stride;
  const uint8_t* sb = sa + Ma;
  const Pair q = load_pair(p, la_, lb_, lw_, up_, u_, v_, tg_, exg_);
  const int gl = WARPS ? threadIdx.x : lane;          // lane within the pair
  const int last = WARPS ? blockDim.x - 1 : 31;
  // the cluster variant's window starts G = 2 L gh.lanes slots below
  // the CTA's own slots
  const int k0 = 2 * L * gl + (CLUSTER ? rank * gh.owned - 2 * L * gh.lanes : 0);

  Band<L> st;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int ke = k0 + 2 * i, ko = ke + 1;
    st.He[i] = CLUSTER && ke < 0 ? kNegSent : init_h(q, ke);
    st.Ho[i] = CLUSTER && ko < 0 ? kNegSent : init_h(q, ko);
    st.Fe[i] = st.Ge[i] = st.Fo[i] = st.Go[i] = kNevsel;
    slot_steps(q, ke, st.lo_e[i], st.hi_e[i]);
    slot_steps(q, ko, st.lo_o[i], st.hi_o[i]);
  }
  if (WARPS) {
    // edges at step 0: each warp's first even slot and last odd slot
    if (lane == 0) {
      ring[4 * warp + 0] = st.He[0];
      ring[4 * warp + 1] = st.Ge[0];
    }
    if (lane == 31) {
      ring[4 * warp + 2] = st.Ho[L - 1];
      ring[4 * warp + 3] = st.Fo[L - 1];
    }
    named_sync(blockDim.x);
  }
  // the cluster variant: its lanes' roles in an exchange, and every CTA
  // of the cluster running before any reaches into another
  const int gL = CLUSTER ? gh.lanes : 0;
  const bool low_ghost = CLUSTER && rank > 0 && gl < gL;
  const bool high_ghost = CLUSTER && rank < gh.ctas - 1 && gl > last - gL;
  const bool push_low = CLUSTER && rank > 0 && gl >= gL && gl < 2 * gL;
  const bool push_high =
      CLUSTER && rank < gh.ctas - 1 && gl > last - 2 * gL && gl <= last - gL;
  if (CLUSTER) {
    cluster_arrive();
    cluster_wait();
  }
  int left = CLUSTER ? gh.every : 0, exch = 0;

  float maxh = kNevsel;
  const int nsteps = q.La + q.Lb - 1;
  for (int d = 0; d < nsteps; ++d) {
    // this step's scores: their loads run beside the shuffles below
    float s[L];
    bool valid[L];
    const int pk = (d + 1 - q.LW) & 1;
    const float* rb = ring + 4 * nwarps * (d & 1);
    if (pk == 0) {
      load_scores<L, 0>(s, valid, st, q, k0, d, sa, sb, smtx, dim);
      // the slot below: the previous lane's last odd slot
      float lo_h = __shfl_up_sync(kFull, st.Ho[L - 1], 1);
      float lo_f = __shfl_up_sync(kFull, st.Fo[L - 1], 1);
      if (lane == 0) {
        const bool edge = WARPS && warp > 0;
        lo_h = edge ? rb[4 * (warp - 1) + 2] : kNegSent;
        lo_f = edge ? rb[4 * (warp - 1) + 3] : kNevsel;
      }
      band_step<L, 0, LOCAL>(st, q, s, valid, lo_h, lo_f, 0.0f, 0.0f, maxh);
    } else {
      load_scores<L, 1>(s, valid, st, q, k0, d, sa, sb, smtx, dim);
      // the slot above: the next lane's first even slot
      float hi_h = __shfl_down_sync(kFull, st.He[0], 1);
      float hi_g = __shfl_down_sync(kFull, st.Ge[0], 1);
      if (lane == 31) {
        const bool edge = WARPS && gl < last;
        hi_h = edge ? rb[4 * (warp + 1) + 0] : kNegSent;
        hi_g = edge ? rb[4 * (warp + 1) + 1] : kNevsel;
      }
      band_step<L, 1, LOCAL>(st, q, s, valid, 0.0f, 0.0f, hi_h, hi_g, maxh);
    }
    if (WARPS) {
      float* wb = ring + 4 * nwarps * ((d + 1) & 1);
      if (lane == 0) {
        wb[4 * warp + 0] = st.He[0];
        wb[4 * warp + 1] = st.Ge[0];
      }
      if (lane == 31) {
        wb[4 * warp + 2] = st.Ho[L - 1];
        wb[4 * warp + 3] = st.Fo[L - 1];
      }
      named_sync(blockDim.x);
    }
    if (CLUSTER && --left == 0) {
      left = gh.every;
      if (d + 1 < nsteps) {
        // the exchange: push the owned edge lanes into the neighbours'
        // ghost buffers of this exchange, meet, load the own ghosts
        float* gb = ghost + 12 * L * gL * (exch & 1);
        ++exch;
        cg::cluster_group cluster = cg::this_cluster();
        if (push_low)
          band_put<L>(st, cluster.map_shared_rank(
                              gb + 6 * L * (gL + (gl - gL)), rank - 1));
        if (push_high)
          band_put<L>(st, cluster.map_shared_rank(
                              gb + 6 * L * (gl - (last - 2 * gL + 1)),
                              rank + 1));
        cluster_arrive();
        cluster_wait();
        if (low_ghost) band_get<L>(st, gb + 6 * L * gl);
        if (high_ghost) band_get<L>(st, gb + 6 * L * (gL + gl - (last - gL + 1)));
      }
    }
  }

  float best0 = kNevsel, best_b = kNevsel, best_a = kNevsel;
  // the cluster variant's ghost lanes hold no slot of their own
  const bool owned = !CLUSTER || (gl >= gL && gl <= last - gL);
  if (LOCAL) {
    best0 = warp_max(owned ? maxh : kNevsel);
  } else {
    if (owned) end_maxima<L>(st, q, k0, nslot, best0, best_b, best_a);
    best0 = warp_max(best0);
    best_b = warp_max(best_b);
    best_a = warp_max(best_a);
  }
  if (WARPS) {
    if (lane == 0) {
      red[warp] = best0;
      red[nwarps + warp] = best_b;
      red[2 * nwarps + warp] = best_a;
    }
    named_sync(blockDim.x);
    if (threadIdx.x == 0) {
      for (int w = 1; w < nwarps; ++w) {
        best0 = fmaxf(best0, red[w]);
        best_b = fmaxf(best_b, red[nwarps + w]);
        best_a = fmaxf(best_a, red[2 * nwarps + w]);
      }
    }
  }
  if (CLUSTER) {
    // the CTAs' maxima into CTA 0's shared memory; maxima are exact in
    // any order
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      float* c0 = cluster.map_shared_rank(cred, 0);
      c0[rank] = best0;
      c0[16 + rank] = best_b;
      c0[32 + rank] = best_a;
    }
    cluster_arrive();
    cluster_wait();
    if (rank != 0) return;
    if (threadIdx.x == 0)
      for (int r = 1; r < gh.ctas; ++r) {
        best0 = fmaxf(best0, cred[r]);
        best_b = fmaxf(best_b, cred[16 + r]);
        best_a = fmaxf(best_a, cred[32 + r]);
      }
  }
  if (gl == 0) out[p] = LOCAL ? best0 : final_score(q, best0, best_b, best_a);
}

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

// The "block" variant: one block of 256 threads a pair, the band state
// in shared memory, one block-wide barrier a step.  DEV: the band state
// in device memory (``state``, 3 maxw floats a pair), and the matrix
// too where ``mtx_shared`` is 0; the block barrier orders the block's
// device-memory writes before its reads as it does its shared ones.
template <bool DEV>
__global__ void pairwise_block_kernel(
    const int32_t* __restrict__ a_batch, const int32_t* __restrict__ b_batch,
    const int32_t* __restrict__ la_, const int32_t* __restrict__ lb_,
    const int32_t* __restrict__ lw_, const int32_t* __restrict__ up_,
    const float* __restrict__ u_, const float* __restrict__ v_,
    const float* __restrict__ tg_, const uint8_t* __restrict__ exg_,
    const float* __restrict__ mtx, float* __restrict__ out, int Ma, int Mb,
    int dim, int local, int maxw, float* state, int mtx_shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockIdx.x;
  const Pair q = load_pair(p, la_, lb_, lw_, up_, u_, v_, tg_, exg_);
  const int32_t* a = a_batch + (size_t)p * Ma;
  const int32_t* b = b_batch + (size_t)p * Mb;
  const int W = q.W;

  float* smtx = reinterpret_cast<float*>(smem);
  float* hh = DEV ? state + (size_t)p * 3 * maxw : smtx + dim * dim;
  float* ff = hh + maxw;
  float* gg = ff + maxw;
  float* red = DEV ? smtx + (mtx_shared ? dim * dim : 0) : gg + maxw;

  if (DEV && !mtx_shared)
    smtx = const_cast<float*>(mtx);
  else
    for (int i = threadIdx.x; i < dim * dim; i += blockDim.x) smtx[i] = mtx[i];
  for (int k = threadIdx.x; k < maxw; k += blockDim.x) {
    hh[k] = init_h(q, k);
    ff[k] = kNevsel;
    gg[k] = kNevsel;
  }
  __syncthreads();

  float maxh = kNevsel;
  const int nsteps = q.La + q.Lb - 1;
  for (int d = 0; d < nsteps; ++d) {
    for (int k = threadIdx.x; k < W; k += blockDim.x) {
      const int r = q.LW - 1 + k;
      if ((d - r) & 1) continue;
      const int m = (d - r) >> 1;
      const int n = d - m;
      if (m < 0 || m >= q.La || n < 0 || n >= q.Lb || r < q.LW || r > q.UP)
        continue;
      const float s = smtx[a[m] * dim + b[n]];
      const float h_lo = k > 0 ? hh[k - 1] : kNegSent;
      const float f_lo = k > 0 ? ff[k - 1] : kNevsel;
      const float h_hi = k < W - 1 ? hh[k + 1] : kNegSent;
      const float g_hi = k < W - 1 ? gg[k + 1] : kNevsel;
      const float f_new = fmaxf(h_lo - q.v, f_lo) - q.u;
      const float g_new = fmaxf(h_hi - q.v, g_hi) - q.u;
      float h_new = fmaxf(fmaxf(hh[k] + s, f_new), g_new);
      if (local) {
        h_new = fmaxf(h_new, 0.0f);
        maxh = fmaxf(maxh, h_new);
      }
      hh[k] = h_new;
      ff[k] = f_new;
      gg[k] = g_new;
    }
    __syncthreads();
  }

  if (local) {
    const float best = block_max(maxh, red);
    if (threadIdx.x == 0) out[p] = best;
    return;
  }
  const int r_end = q.Lb - q.La;
  const float f_b = q.exg3 ? 0.0f : q.tgapf;
  const float f_a = q.exg1 ? 0.0f : q.tgapf;
  const int hi_b = min(q.UP + 1, q.Lb);
  const int lo_a = max(q.LW - 1, -q.La + 1);
  float best0 = kNevsel, best_b = kNevsel, best_a = kNevsel;
  for (int k = threadIdx.x; k < maxw; k += blockDim.x) {
    const int r = q.LW - 1 + k;
    const float h = hh[k];
    if (r == r_end) best0 = fmaxf(best0, h);
    if (r > r_end && r <= hi_b)
      best_b = fmaxf(best_b, h - f_b * (q.v + (float)(r - r_end) * q.u));
    if (r < r_end && r >= lo_a)
      best_a = fmaxf(best_a, h - f_a * (q.v + (float)(r_end - r) * q.u));
  }
  const float best = block_max(best0, red);
  best_b = block_max(best_b, red);
  best_a = block_max(best_a, red);
  if (threadIdx.x == 0) out[p] = final_score(q, best, best_b, best_a);
}

using RegKernel = void (*)(const int32_t*, const int32_t*, const int32_t*,
                           const int32_t*, const int32_t*, const int32_t*,
                           const float*, const float*, const float*,
                           const uint8_t*, const float*, float*, int, int,
                           int, int, int, int, Ghost);

template <bool LOCAL, bool WARPS, bool CLUSTER>
RegKernel reg_kernel(int lanes) {
  switch (lanes) {
    case 1: return pairwise_reg_kernel<1, LOCAL, WARPS, CLUSTER>;
    case 2: return pairwise_reg_kernel<2, LOCAL, WARPS, CLUSTER>;
    case 3: return pairwise_reg_kernel<3, LOCAL, WARPS, CLUSTER>;
    case 4: return pairwise_reg_kernel<4, LOCAL, WARPS, CLUSTER>;
    case 5: return pairwise_reg_kernel<5, LOCAL, WARPS, CLUSTER>;
    case 6: return pairwise_reg_kernel<6, LOCAL, WARPS, CLUSTER>;
    case 8: return pairwise_reg_kernel<8, LOCAL, WARPS, CLUSTER>;
    case 10: return pairwise_reg_kernel<10, LOCAL, WARPS, CLUSTER>;
  }
  return nullptr;
}

// the register-state kernel of a variant (1: warp, 2: warps, 3:
// cluster), or null
RegKernel pick_kernel(int variant, int lanes, int local) {
  if (variant == 1)
    return local ? reg_kernel<true, false, false>(lanes)
                 : reg_kernel<false, false, false>(lanes);
  if (variant == 2)
    return local ? reg_kernel<true, true, false>(lanes)
                 : reg_kernel<false, true, false>(lanes);
  if (variant == 3)
    return local ? reg_kernel<true, true, true>(lanes)
                 : reg_kernel<false, true, true>(lanes);
  return nullptr;
}

}  // namespace

// variant 0: block (threads ignored; ``state`` null: the band in shared
// memory, else in ``state``, 3 maxw floats a pair, and the matrix in
// shared memory where smem_bytes holds it); 1: warp (threads / 32 pairs
// a block); 2: warps (threads / 32 warps a pair); 3: cluster (ctas CTAs
// of threads / 32 warps a pair, ghost lanes a side, an exchange every
// ``every`` steps).  lanes: slot pairs a lane (1-6, 8 or 10);
// code_stride: bytes of a pair's codes.
extern "C" int pairwise_scores_launch(
    const void* a_batch, const void* b_batch, const void* la, const void* lb,
    const void* lw, const void* up, const void* u, const void* v,
    const void* tgapf, const void* exg, const void* mtx, void* out,
    void* state, int B, int Ma, int Mb, int dim, int local, int maxw,
    int variant, int lanes, int threads, int code_stride, int smem_bytes,
    int ctas, int ghost, int every, void* stream) {
  const int32_t* a = (const int32_t*)a_batch;
  const int32_t* b = (const int32_t*)b_batch;
  const int32_t *la_ = (const int32_t*)la, *lb_ = (const int32_t*)lb;
  const int32_t *lw_ = (const int32_t*)lw, *up_ = (const int32_t*)up;
  const float *u_ = (const float*)u, *v_ = (const float*)v;
  const float* tg_ = (const float*)tgapf;
  const uint8_t* exg_ = (const uint8_t*)exg;
  const float* mtx_ = (const float*)mtx;
  float* out_ = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 0) {
    cudaError_t err;
    if (state == nullptr) {
      const size_t smem =
          sizeof(float) * ((size_t)dim * dim + 3 * (size_t)maxw + 32);
      err = cudaFuncSetAttribute(pairwise_block_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      pairwise_block_kernel<false><<<B, kBlockThreads, smem, st>>>(
          a, b, la_, lb_, lw_, up_, u_, v_, tg_, exg_, mtx_, out_, Ma, Mb,
          dim, local, maxw, nullptr, 1);
      return (int)cudaGetLastError();
    }
    const size_t with_mtx = sizeof(float) * ((size_t)dim * dim + 32);
    const int mtx_shared = (size_t)smem_bytes >= with_mtx;
    if (smem_bytes < (int)(32 * sizeof(float))) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(pairwise_block_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
    pairwise_block_kernel<true><<<B, kBlockThreads, smem_bytes, st>>>(
        a, b, la_, lb_, lw_, up_, u_, v_, tg_, exg_, mtx_, out_, Ma, Mb, dim,
        local, maxw, (float*)state, mtx_shared);
    return (int)cudaGetLastError();
  }
  const RegKernel kern = pick_kernel(variant, lanes, local);
  const int nw = threads / 32;
  // a cluster CTA owns its window less a ghost of ``ghost`` lanes a side
  const int owned = 2 * lanes * (threads - 2 * ghost);
  if (kern == nullptr || threads < 32 || threads > 512 || threads % 32 != 0 ||
      (variant == 2 && 64 * lanes * nw < maxw) ||
      (variant == 1 && 64 * lanes < maxw) || dim > 256 ||
      (variant == 3 &&
       (ctas < 2 || ctas > 16 || ghost < 1 || ghost > 31 ||
        threads < 4 * ghost || every < 1 || every > 2 * lanes * ghost ||
        (long long)ctas * owned < maxw)))
    return (int)cudaErrorInvalidValue;
  const Ghost gh{ctas, ghost, every, owned};
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  if (variant == 3) {
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
                             tg_, exg_, mtx_, out_, B, Ma, Mb, dim, maxw,
                             code_stride, gh);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const int per_block = variant == 1 ? nw : 1;
  kern<<<(B + per_block - 1) / per_block, threads, smem_bytes, st>>>(
      a, b, la_, lb_, lw_, up_, u_, v_, tg_, exg_, mtx_, out_, B, Ma, Mb,
      dim, maxw, code_stride, gh);
  return (int)cudaGetLastError();
}

// registers a thread and local (spilled) bytes of a variant's kernel
// (variant 0: the block variant with its band in shared memory; 4: in
// device memory)
extern "C" int pairwise_scores_attrs(int variant, int lanes, int local,
                                     void* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      variant == 0   ? cudaFuncGetAttributes(&attr, pairwise_block_kernel<false>)
      : variant == 4 ? cudaFuncGetAttributes(&attr, pairwise_block_kernel<true>)
      : pick_kernel(variant, lanes, local) == nullptr
          ? cudaErrorInvalidValue
          : cudaFuncGetAttributes(&attr, pick_kernel(variant, lanes, local));
  if (err != cudaSuccess) return (int)err;
  ((int*)out)[0] = attr.numRegs;
  ((int*)out)[1] = (int)attr.localSizeBytes;
  return 0;
}
