// Kernel K4: the fwd2h forward sweep (protein or profile x genomic DNA
// with introns and frameshifts), one wave t = 3m + n per step.
//
// Replaces prrn_aln_tpu/ops/pallas_spliced_h.py::_make_kernel (:201),
// the Pallas wave kernel.  Its plain version is
// ops/spliced_h.py::sweep_h_ref, a transcription of the JAX scan engine
// spliced_h_jax._sweep_h; both run the same float operations in the
// same order (built with -fmad=false), so their planes are equal.
//
// What bounds it on the card: one dependent chain of T = t_max - t_min
// + 1 waves (about 3M + N), each closed by a barrier, with a few hundred
// scalar operations and some 200 dependent loads per row (ring records,
// candidate lists, per-position tables): latency, not bandwidth.  The
// bytes it must write are 28 B per wave-row (ev, jd x 4, V, D), 540 MB
// at the 34.9 kb x 526-column flagship shape, about 0.16 ms at the
// card's memory rate.
//
// What the design does about it: one block per alignment and one
// thread per row (rows m, m + blockDim, ... when M + 1 exceeds 512), so
// all rows of a wave run at once and a barrier is the only
// synchronisation: row m at wave t reads row m - 1 only at waves t - 3
// ... t - 6, which earlier barriers made visible.  Every record a row
// keeps across waves lives in a global scratch the wrapper allocates,
// laid out field by field with the row fastest so a warp's accesses
// coalesce, and small enough (182 words a row, 384 KB at 527 rows) to
// stay in L1/L2: the H ring (8 waves deep, read by the row itself at
// t - 1 ... t - 3 and by row m + 1 at t - 3 ... t - 6), the ne ring, the
// G and sj rings, and the three per-phase donor candidate lists.  The
// TPU layout devices (the (8, 128) row tile, flipped stride-3 tables,
// lane rolls, pre-shifted ring copies, the select tree over profile
// columns) have no reason here: a thread reads its genome positions and
// profile entries directly.  The intron penalty is the 806-entry table
// in shared memory, as the scan engine computes it (the TPU kernel
// evaluated a closed form instead, to avoid a gather).  The planes stay
// in device memory for K4w (csrc/spliced_h_walk.cu).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEVSEL = -8.9e30f;
constexpr int DIAG = 2, NEWD = 3, VERT = 4, HORI = 8, SPIN = 16,
              SPJCI = 48;
constexpr int NCAND = 4, NSLOT = 5, INTR = 2, TSIMD = 26, NCOL = 13;
constexpr int EVH_SJ = 1 << 2, EVH_JXH = 1 << 7, EVH_JXF = 1 << 8,
              EVH_JXG = 1 << 9, EVH_CSH = 1 << 10;
// table columns (ops/spliced_h.py TAB_FILL)
constexpr int C_TRN = 0, C_SIGE = 1, C_PHS5 = 2, C_PHS3 = 3, C_SIG5 = 4,
              C_DINC3 = 5, C_SSS3 = 6, C_E3 = 7, C_A2 = 8;

struct Rec {
  float V;
  int D, GA, GB, J;
};

struct Params {
  const float* tab;      // (N + 2, NCOL)
  const int* dinc5;      // (N + 1,)
  const int* r1idx;      // (N + 1,)
  const int* A1;         // (N + 1, 5)
  const float* pair53;   // (16, 16)
  const float* qprof;    // (M + 2, TSIMD)
  const float* pen;      // (npen,) intron penalty over [llmt, rlmt]
  const float* api;      // (3M + 4,)
  const float* h0v;      // (W + 6,)
  const int* h0i;        // (4, W + 6): D, GA, GB, J
  const int* e1i;        // (4,)
  const float* fprm;     // FPRM order
  int* ring;
  int* ev;
  int* jd;
  float* Vp;
  int* Dp;
  int M, N, lw, up, a_exgr, e1pre_t, llmt, rlmt, npen, trm, trm2, amb;
};

__device__ __forceinline__ float tfill(int col) {
  return (col == C_PHS5 || col == C_PHS3) ? -2.0f : col == C_E3 ? 4.0f
                                                                 : 0.0f;
}

__device__ __forceinline__ bool is_vert(int x) {
  x &= 15;
  return (x >= 4 && x <= 7) || x == 12;
}

__device__ __forceinline__ bool is_hori(int x) {
  x &= 15;
  return (x >= 8 && x <= 11) || x == 13;
}

__device__ __forceinline__ int d2n(int x) {
  x &= 15;
  if (x == DIAG || x == NEWD) return 0;
  if ((x >= 8 && x <= 10) || x == 13) return 1;
  if ((x >= 4 && x <= 6) || x == 12) return 2;
  if (x == 11) return 3;
  if (x == 7) return 4;
  return -1;
}

__global__ void __launch_bounds__(512)
spliced_h_wave_kernel(Params p, int rpt) {
  extern __shared__ float smem[];
  float* pen = smem;                 // npen entries
  float* p53 = smem + p.npen;        // 16 x 16
  const int M = p.M, N = p.N, lw = p.lw, up = p.up;
  const int MR = M + 1, TL = N + 2;
  const int off0 = 3 - lw, LL = off0, r0_max = min(up, N);
  const int t_min = 3 + max(3 + lw, 1);
  const int t_max = 3 * M + min(3 * M + up, N);
  const int W6 = up - lw + 7;
  const float gop = p.fprm[0], gep = p.fprm[1], gap_e1 = p.fprm[2],
              gap_e2 = p.fprm[3], gap_w1 = p.fprm[4], gap_w2 = p.fprm[5],
              fO = p.fprm[6], e1V = p.fprm[7], mu = p.fprm[8],
              int_ep = p.fprm[9], int_fx = p.fprm[10], gap_wi = p.fprm[11];
  const float* __restrict__ tab = p.tab;
  const float* __restrict__ qp = p.qprof;

  // scratch, field-major with the row fastest
  int* base = p.ring;
  float* hV = (float*)base;  base += 8 * MR;
  int* hD = base;            base += 8 * MR;
  int* hGA = base;           base += 8 * MR;
  int* hGB = base;           base += 8 * MR;
  int* hJ = base;            base += 8 * MR;
  float* nV = (float*)base;  base += 4 * MR;
  int* nD = base;            base += 4 * MR;
  int* nGA = base;           base += 4 * MR;
  int* nJ = base;            base += 4 * MR;
  float* gVr = (float*)base; base += 4 * MR;
  int* gDr = base;           base += 4 * MR;
  int* gGBr = base;          base += 4 * MR;
  int* gJr = base;           base += 4 * MR;
  float* sV = (float*)base;  base += 8 * MR;
  int* sD = base;            base += 8 * MR;
  int* sJ = base;            base += 8 * MR;
  int* sK = base;            base += 8 * MR;
  float* clV = (float*)base; base += 3 * NSLOT * MR;
  int* clJ = base;           base += 3 * NSLOT * MR;
  int* clD = base;           base += 3 * NSLOT * MR;
  int* clCS = base;          base += 3 * NSLOT * MR;
  int* nxs = base;           base += 3 * NSLOT * MR;
  int* ncand = base;

  for (int i = threadIdx.x; i < p.npen; i += blockDim.x) pen[i] = p.pen[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) p53[i] = p.pair53[i];
  for (int r = 0; r < rpt; ++r) {
    const int m = threadIdx.x + r * blockDim.x;
    if (m > M) break;
    for (int s = 0; s < 8; ++s) {
      hV[s * MR + m] = NEVSEL;
      hD[s * MR + m] = hGA[s * MR + m] = hGB[s * MR + m] = hJ[s * MR + m] = 0;
      sV[s * MR + m] = NEVSEL;
      sD[s * MR + m] = sJ[s * MR + m] = sK[s * MR + m] = 0;
    }
    for (int s = 0; s < 4; ++s) {
      nV[s * MR + m] = NEVSEL;
      nD[s * MR + m] = nGA[s * MR + m] = nJ[s * MR + m] = 0;
      gVr[s * MR + m] = NEVSEL;
      gDr[s * MR + m] = gGBr[s * MR + m] = gJr[s * MR + m] = 0;
    }
    for (int s = 0; s < 3 * NSLOT; ++s) {
      clV[s * MR + m] = NEVSEL;
      clJ[s * MR + m] = clD[s * MR + m] = clCS[s * MR + m] = 0;
      nxs[s * MR + m] = s % NSLOT;
    }
    for (int l = 0; l < 3; ++l) ncand[l * MR + m] = 0;
  }
  __syncthreads();

  auto tb = [&](int c, int col) -> float {
    return (c >= 0 && c < TL) ? tab[c * NCOL + col] : tfill(col);
  };
  auto api_at = [&](int i) -> float {
    return (i >= 0 && i < 3 * M + 4) ? p.api[i] : 0.0f;
  };
  auto h0rec = [&](int s) -> Rec {
    return Rec{p.h0v[s], p.h0i[s], p.h0i[W6 + s], p.h0i[2 * W6 + s],
               p.h0i[3 * W6 + s]};
  };
  // initH records: top row by column, left column by ii = 3m - n
  auto top = [&](int c) -> Rec {
    return (c >= 0 && c <= r0_max) ? h0rec(off0 + c)
                                   : Rec{NEVSEL, 0, 0, 0, 0};
  };
  auto left = [&](int j) -> Rec {
    return (j >= 0 && j <= LL) ? h0rec(off0 - j) : Rec{0.0f, 0, 0, 0, 0};
  };
  auto ringH = [&](int t, int mm) -> Rec {
    const int s = (t & 7) * MR + mm;
    return Rec{hV[s], hD[s], hGA[s], hGB[s], hJ[s]};
  };
  auto penalty = [&](int len) -> float {
    if (len < 0) return gap_wi;
    if (len < p.llmt) return NEVSEL;
    if (len >= p.rlmt) {
      // XLA's fused multiply-add, as an f64 product and add rounded once
      const float lg = logf(fmaxf((float)len - mu, 1.0f));
      return (float)((double)int_ep * (double)lg + (double)int_fx);
    }
    return pen[min(max(len - p.llmt, 0), p.npen - 1)];
  };
  const Rec guard{NEVSEL, 0, 0, 0, 0};

  for (int t = t_min; t <= t_max; ++t) {
    const int wi = t - t_min;
    for (int r = 0; r < rpt; ++r) {
      const int m = threadIdx.x + r * blockDim.x;
      if (m > M) break;
      const int n = t - 3 * m;
      const int nfm = max(3 * m + lw, 1), nlm = min(3 * m + up, N);
      const int nf1 = max(3 * (m - 1) + lw, 1), nl1 = min(3 * (m - 1) + up, N);
      const bool valid = m >= 1 && n >= nfm && n <= nlm;
      const bool internal = !p.a_exgr || m < M;
      const float pua = internal ? gep : 0.0f;

      // (m - 1, n - off) from the ring at wave t - 3 - off; row 1 reads
      // the top-row init record; before the band, the left column (the
      // scan engine pairs the record at 6m - t - off with this guard)
      auto below = [&](int off) -> Rec {
        const int col = n - off;
        const bool ok = m >= 2 && col >= nf1 && col <= nl1;
        Rec out = ok ? ringH(t - 3 - off, m - 1) : guard;
        const int ii = 3 * (m - 1) - col;
        if (!ok && m >= 2 && col <= 0 && ii >= 0 && ii <= LL)
          out = left(6 * m - t - off);
        if (m == 1) out = top(t - 3 - off);
        return out;
      };
      // (m, n - k) from the ring at wave t - k; before the band, the
      // left-column record
      auto same = [&](int k) -> Rec {
        const int nk = n - k;
        const bool use = nk >= nfm;
        Rec out = use ? ringH(t - k, m) : guard;
        const int j = 3 * m - nk;
        if (!use && nk <= 0 && j >= 0 && j <= LL) out = left(j);
        return out;
      };
      const Rec hq = below(3), f1 = below(2), f2 = below(1), f3 = below(0);
      Rec gd = guard;
      float sjV = NEVSEL;
      int sjDv = 0, sjJ_ = 0, sjK_ = 0;
      if (m >= 2 && n >= nf1 && n <= nl1) {
        const int s = ((t - 3) & 3) * MR + m - 1;
        gd = Rec{gVr[s], gDr[s], 0, gGBr[s], gJr[s]};
      }
      if (m >= 2 && n - 3 >= nf1 && n - 3 <= nl1) {
        const int s = ((t - 6) & 7) * MR + m - 1;
        sjV = sV[s];
        sjDv = sD[s];
        sjJ_ = sJ[s];
        sjK_ = sK[s];
      }
      const Rec b1 = same(1), b2 = same(2), b3 = same(3);
      Rec eq = guard;
      if (n - 3 >= nfm) {
        const int s = ((t - 3) & 3) * MR + m;
        eq = Rec{nV[s], nD[s], nGA[s], 0, nJ[s]};
      }
      if (t == p.e1pre_t && m == 1)
        eq = Rec{e1V, p.e1i[0], p.e1i[1], p.e1i[2], p.e1i[3]};

      const float sE = n >= 2 ? tb(n - 2, C_SIGE) : 0.0f;

      // ---- diagonal (or sj crossing)
      const bool sj_used = sjDv != 0 && n > 2;
      const float dv = qp[m * TSIMD + (int)tb(n - 2, C_TRN)] + sE;
      float hV_ = NEVSEL;
      int hD_ = 0, hJ_ = 0;
      if (n > 2) {
        hV_ = sj_used ? sjV : hq.V + dv;
        hJ_ = sj_used ? sjJ_ : hq.J;
        const int src = (sj_used ? sjDv : hq.D) & 15;
        hD_ = (src == DIAG || src == NEWD) ? DIAG : NEWD;
      }

      // ---- vertical + frameshift deletions
      const float c0 = gd.V + (gd.GA >= gd.GB ? gop : 0.0f);
      const float c1 = f1.V + (is_vert(f1.D) ? gap_e1 : gap_w1);
      const float c2 = f2.V + (is_vert(f2.D) ? gap_e2 : gap_w2);
      const float c3 = f3.V + (f3.GA >= f3.GB ? gop : 0.0f);
      int vk = 0;
      float vb = c0;
      if (c1 > vb) { vk = 1; vb = c1; }
      if (c2 > vb) { vk = 2; vb = c2; }
      if (c3 > vb) { vk = 3; vb = c3; }
      const Rec& vs = vk == 0 ? gd : vk == 1 ? f1 : vk == 2 ? f2 : f3;
      float gV = vb + pua;
      const int gGB = vs.GB + (vk == 0 ? 3 : vk);
      int gJ = vs.J;
      int gD = (vk == 1 ? 5 : vk == 2 ? 6 : VERT) | (vs.D & SPIN);

      // ---- horizontal + frameshift insertions
      const float hc0 = n > 2 ? eq.V : NEVSEL;
      const float hc3 =
          n > 2 ? b3.V + (b3.GA <= b3.GB ? gop : 0.0f) : NEVSEL;
      const float hc2 =
          n > 1 ? b2.V + (is_hori(b2.D) ? gap_e2 : gap_w2) : NEVSEL;
      const float hc1 = b1.V + (is_hori(b1.D) ? gap_e1 : gap_w1);
      int hk = 0;
      float hb = hc0;
      if (hc1 > hb) { hk = 1; hb = hc1; }
      if (hc2 > hb) { hk = 2; hb = hc2; }
      if (hc3 > hb) { hk = 3; hb = hc3; }
      const Rec& hs = hk == 0 ? eq : hk == 1 ? b1 : hk == 2 ? b2 : b3;
      float x = hb - hs.V;
      x = x + gep;
      x = x + sE;
      float neV = hs.V + x;
      const int neGA = hs.GA + (hk == 0 ? 3 : hk);
      int neJ = hs.J;
      int neD = (hk == 1 ? 9 : hk == 2 ? 10 : HORI) | (hs.D & SPIN);

      // ---- running max
      int w = gV > hV_ ? 2 : 0;
      float mxV = fmaxf(gV, hV_);
      if (neV >= mxV) w = 1;
      mxV = fmaxf(neV, mxV);

      // ---- 3' acceptor merges (per phase)
      bool jx[3] = {false, false, false};
      int jdon[3] = {0, 0, 0}, jnb[3] = {0, 0, 0};
      bool jcs0 = false;
      float lvV[3] = {hV_, neV, gV};
      float sj_nV = NEVSEL;
      int sj_nJ = 0, sj_nK = 0;
      bool sj_set = false, sj_clr = false;
      const int p3 = (int)tb(n, C_PHS3);
      const bool has_acc = valid && internal && n < N && p3 != -2;
      const int nxt_aa = n + 1 < N ? (int)tb(n + 1, C_TRN) : p.amb;
      const float qp1_nxt = qp[(m + 1) * TSIMD + nxt_aa];
      for (int pi = 0; pi < 2; ++pi) {
        const int phs = pi == 0 ? (p3 == 2 ? -1 : p3) : 1;
        const bool ap = pi == 0 ? has_acc : (has_acc && p3 == 2);
        const int nb = n - phs;
        const bool is_p1 = phs == 1, is_m1 = phs == -1;
        const int cv = is_p1 ? n - 1 : is_m1 ? n + 1 : n;
        const int dinc3v = (int)tb(cv, C_DINC3);
        const float sss3v = tb(cv, C_SSS3);
        const int e3v = (int)tb(cv, C_E3);
        const float sigJ = is_p1 ? api_at(3 * m - 1)
                                 : is_m1 ? api_at(3 * m + 1) : api_at(3 * m);
        const int li = min(max(phs + 1, 0), 2);
        const int nc_li = ncand[li * MR + m];
        float xm[NCAND], y[NCAND];
        int cJ[NCAND], cD[NCAND], cCS[NCAND];
        bool act[NCAND];
        for (int k = 0; k < NCAND; ++k) {
          const int s = (li * NSLOT + nxs[(li * NSLOT + k) * MR + m]) * MR + m;
          const float cV = clV[s];
          cJ[k] = clJ[s];
          cD[k] = clD[s];
          cCS[k] = clCS[s];
          act[k] = ap && k < nc_li;
          const int cJc = min(max(cJ[k], 0), N);
          float v = cV + sigJ;
          v = v + penalty(nb - cJ[k]);
          v = v + p53[p.dinc5[cJc] * 16 + dinc3v];
          v = v + sss3v;
          const int aa1 = p.A1[cJc * 5 + e3v];
          const float pm1 = (aa1 == p.trm || aa1 == p.trm2) ? fO : 0.0f;
          const float qa1 = qp[m * TSIMD + aa1];
          v = v + ((cD[k] == 0 && is_p1) ? pm1 + qa1 : 0.0f);
          const int aa2 = (int)tb(cv, C_A2 + p.r1idx[cJc]);
          const float pm2 = (aa2 == p.trm || aa2 == p.trm2) ? fO : 0.0f;
          float yk = v + pm2;
          yk = yk + qp[(m + 1) * TSIMD + aa2];
          xm[k] = v;
          y[k] = yk;
        }
        // sj shadow: the last qualifying rank wins
        const float thr = mxV + qp1_nxt;
        bool any_sj = false;
        int last = 0;
        for (int k = 0; k < NCAND; ++k)
          if (act[k] && cD[k] == 0 && is_m1 && y[k] > thr) {
            any_sj = true;
            last = k;
          }
        if (any_sj) {
          sj_nV = y[last];
          sj_nJ = nb;
          sj_nK = cJ[last] + phs;
        }
        sj_set = sj_set || any_sj;
        // per-lane best candidate: the first rank reaching the max
        bool merged0 = false;
        for (int lane = 0; lane < 3; ++lane) {
          bool anyin = act[0] && cD[0] == lane;
          float bx = anyin ? xm[0] : NEVSEL;
          int best = 0;
          for (int k = 1; k < NCAND; ++k) {
            const bool inl = act[k] && cD[k] == lane;
            const float v = inl ? xm[k] : NEVSEL;
            if (v > bx) {
              best = k;
              bx = v;
            }
            anyin = anyin || inl;
          }
          const bool better = anyin && bx > lvV[lane];
          if (better) {
            lvV[lane] = bx;
            jx[lane] = true;
            jdon[lane] = cJ[best] + phs;
            jnb[lane] = nb;
          }
          if (lane == 0) {
            if (better) jcs0 = cCS[best] != 0;
            merged0 = better;
          }
        }
        sj_clr = sj_clr || (ap && is_m1 && merged0);
        mxV = w == 1 ? lvV[1] : w == 2 ? lvV[2] : lvV[0];
        for (int k = 0; k < 3; ++k)
          if (jx[k] && lvV[k] > mxV) {
            w = k;
            mxV = lvV[k];
          }
      }
      hV_ = lvV[0];
      neV = lvV[1];
      gV = lvV[2];
      if (jx[0]) { hD_ |= SPJCI; hJ_ = jnb[0]; }
      if (jx[1]) { neD |= SPJCI; neJ = jnb[1]; }
      if (jx[2]) { gD |= SPJCI; gJ = jnb[2]; }
      const bool sj_on = sj_set && !sj_clr;

      // ---- the cell record
      const float cVx = w == 1 ? neV : w == 2 ? gV : hV_;
      const int cDx = w == 1 ? neD : w == 2 ? gD : hD_;
      const int cGAx = w == 1 ? neGA : 0;
      const int cGBx = w == 2 ? gGB : 0;
      const int cJx = w == 1 ? neJ : w == 2 ? gJ : hJ_;

      // ---- 5' donor pushes (per phase)
      const int p5 = (int)tb(n, C_PHS5);
      const bool has_don = valid && internal && n < N && p5 != -2;
      const float lvV2[3] = {cVx, neV, gV};
      const int lvD2[3] = {cDx, neD, gD};
      const int hd = d2n(cDx);
      for (int pi = 0; pi < 2; ++pi) {
        const int phs = pi == 0 ? (p5 == 2 ? -1 : p5) : 1;
        const bool dp = pi == 0 ? has_don : (has_don && p5 == 2);
        if (!dp) continue;
        const int nb = n - phs;
        const bool is_p1 = phs == 1, is_m1 = phs == -1;
        const float sigJ = tb(is_p1 ? n - 1 : is_m1 ? n + 1 : n, C_SIG5);
        const int li = min(max(phs + 1, 0), 2);
        int nxrow[NSLOT], laneJ[NSLOT], laneD[NSLOT], laneCS[NSLOT];
        float laneV[NSLOT];
        for (int j = 0; j < NSLOT; ++j) {
          const int s = (li * NSLOT + j) * MR + m;
          nxrow[j] = nxs[s];
          laneV[j] = clV[s];
          laneJ[j] = clJ[s];
          laneD[j] = clD[s];
          laneCS[j] = clCS[s];
        }
        int ncl = ncand[li * MR + m];
        bool touched = false;
        for (int k = 0; k < 3; ++k) {
          const bool cross = is_p1 && k == 0;
          bool ok = dp;
          if (k == 0) ok = ok && (hd == 0 || is_p1);
          const float fV = cross ? hq.V : lvV2[k];
          const int fD = cross ? hq.D : lvD2[k];
          ok = ok && fD != 0 && (fD & SPIN) == 0;
          const bool thr_on = !cross && hd != k && hd >= 0;
          const float yk =
              mxV + ((hd == 0 || (k - hd) % 2 != 0) ? (k == 2 ? gop : 0.0f)
                                                     : 0.0f);
          ok = ok && (!thr_on || fV > yk);
          if (!ok) continue;
          const float xp = fV + sigJ;
          const int nc1 = min(ncl + 1, NCAND);
          const int l_start = ncl < NCAND ? ncl + 1 : NCAND;
          int pos = 0;
          for (int j = 0; j < NSLOT; ++j)
            if (j < l_start && laneV[nxrow[j]] >= xp) ++pos;
          const int at_ls = nxrow[l_start];
          int nn[NSLOT];
          for (int j = 0; j < NSLOT; ++j)
            nn[j] = j < pos ? nxrow[j]
                    : j == pos ? at_ls
                    : j <= l_start ? nxrow[j == 0 ? 0 : j - 1]
                                   : nxrow[j];
          const bool accept = pos < INTR;
          if (accept) {
            laneV[at_ls] = xp;
            laneJ[at_ls] = nb;
            laneD[at_ls] = k;
            laneCS[at_ls] = cross ? 1 : 0;
          }
          for (int j = 0; j < NSLOT; ++j) nxrow[j] = nn[j];
          ncl = accept ? nc1 : nc1 - 1;
          touched = true;
        }
        if (touched) {
          for (int j = 0; j < NSLOT; ++j) {
            const int s = (li * NSLOT + j) * MR + m;
            nxs[s] = nxrow[j];
            clV[s] = laneV[j];
            clJ[s] = laneJ[j];
            clD[s] = laneD[j];
            clCS[s] = laneCS[j];
          }
          ncand[li * MR + m] = ncl;
        }
      }

      // ---- planes
      const int evv = w | (sj_used ? EVH_SJ : 0) | (vk << 3) | (hk << 5) |
                      (jx[0] ? EVH_JXH : 0) | (jx[1] ? EVH_JXF : 0) |
                      (jx[2] ? EVH_JXG : 0) | (jcs0 ? EVH_CSH : 0);
      const size_t o = (size_t)wi * MR + m;
      p.ev[o] = valid ? evv : -1;
      p.Vp[o] = cVx;
      p.Dp[o] = cDx;
      const size_t oj = (size_t)wi * 4 * MR + m;
      p.jd[oj] = jdon[0];
      p.jd[oj + MR] = jdon[1];
      p.jd[oj + 2 * MR] = jdon[2];
      p.jd[oj + 3 * MR] = sj_used ? sjK_ : 0;

      // ---- ring writes
      const int s8 = (t & 7) * MR + m, s4 = (t & 3) * MR + m;
      hV[s8] = cVx;
      hD[s8] = cDx;
      hGA[s8] = cGAx;
      hGB[s8] = cGBx;
      hJ[s8] = cJx;
      nV[s4] = neV;
      nD[s4] = neD;
      nGA[s4] = neGA;
      nJ[s4] = neJ;
      gVr[s4] = gV;
      gDr[s4] = gD;
      gGBr[s4] = gGB;
      gJr[s4] = gJ;
      sV[s8] = sj_on ? sj_nV : NEVSEL;
      sD[s8] = sj_on ? NEWD : 0;
      sJ[s8] = sj_on ? sj_nJ : 0;
      sK[s8] = sj_on ? sj_nK : 0;
    }
    __syncthreads();
  }
}

}  // namespace

// Words of scratch a row needs: H ring 8 x 5, ne and G rings 4 x 4
// each, sj ring 8 x 4, candidate lists 5 x 3 x NSLOT, counts 3.  The
// wrapper allocates this many times M + 1.
extern "C" int spliced_h_wave_scratch_words() {
  return 8 * 5 + 4 * 4 + 4 * 4 + 8 * 4 + 5 * 3 * NSLOT + 3;
}

extern "C" int spliced_h_wave_launch(
    const void* tab, const void* dinc5, const void* r1idx, const void* A1,
    const void* pair53, const void* qprof, const void* api, const void* pen,
    const void* h0v, const void* h0i, const void* e1i, const void* fprm,
    void* ring, void* ev, void* jd, void* V, void* D, int M, int N, int lw,
    int up, int a_exgr, int e1pre_t, int llmt, int rlmt, int trm, int trm2,
    int amb, int rpt, int threads, void* stream) {
  Params p;
  p.tab = (const float*)tab;
  p.dinc5 = (const int*)dinc5;
  p.r1idx = (const int*)r1idx;
  p.A1 = (const int*)A1;
  p.pair53 = (const float*)pair53;
  p.qprof = (const float*)qprof;
  p.pen = (const float*)pen;
  p.api = (const float*)api;
  p.h0v = (const float*)h0v;
  p.h0i = (const int*)h0i;
  p.e1i = (const int*)e1i;
  p.fprm = (const float*)fprm;
  p.ring = (int*)ring;
  p.ev = (int*)ev;
  p.jd = (int*)jd;
  p.Vp = (float*)V;
  p.Dp = (int*)D;
  p.M = M;
  p.N = N;
  p.lw = lw;
  p.up = up;
  p.a_exgr = a_exgr;
  p.e1pre_t = e1pre_t;
  p.llmt = llmt;
  p.rlmt = rlmt;
  p.npen = rlmt - llmt + 1;
  p.trm = trm;
  p.trm2 = trm2;
  p.amb = amb;
  const size_t smem = (size_t)(p.npen + 256) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  spliced_h_wave_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(p, rpt);
  return (int)cudaGetLastError();
}
