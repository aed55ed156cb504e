// Kernel K4: the fwd2h forward sweep (protein or profile x genomic DNA
// with introns and frameshifts), one wave t = 3m + n per step.
//
// Replaces prrn_aln_tpu/ops/pallas_spliced_h.py::_make_kernel (:201),
// the Pallas wave kernel.  Its plain version is
// ops/spliced_h.py::sweep_h_ref, a transcription of the JAX scan engine
// spliced_h_jax._sweep_h; both run the same float operations in the
// same order (built with -fmad=false), so their planes are equal.
//
// The work: one dependent chain of T = t_max - t_min + 1 waves (about
// 3M + N).  At a wave every row m takes one cell, which reads its own
// records of the last three waves and row m - 1's of waves t - 3 ... t - 6,
// then merges up to 4 donor candidates of each acceptor phase and pushes
// up to 3 new ones into its three rank-ordered donor lists: some
// hundreds of scalar operations a row, and branches that differ from row
// to row.  The bytes it must write are 28 B a wave-row (ev, jd x 4, V,
// D), 540 MB at the 34.9 kb x 526-column flagship shape, about 0.16 ms at
// the card's memory rate; the bound is far below what the chain allows.
//
// What bounds it on the H100: the latency of one warp's row step.  With
// one row a thread a CTA holds at most 8 warps, one or two on each of the
// SM's four schedulers, so nothing hides a warp's dependent loads and
// compares; tools/k4_bench.py --profile times the sections of a step
// (the acceptor merges and the donor pushes are the largest, then the
// waits at the cluster barrier, which stand for the steps in which one
// warp ran both phases of a path and the others did not).
//
// The design, two variants chosen by size (ops/spliced_h.py::sweep_plan):
// - The cluster variant, up to 8 CTAs of up to 256 rows: one row a
//   thread, a slab of consecutive rows a CTA, the CTAs one thread-block
//   cluster.  Only what row m + 1 reads lives in shared memory: the H
//   and G rings and the sj ring (kHD and kSD waves deep); the first row
//   of a slab reads the last row of the previous CTA's slab through
//   distributed shared memory.  What only row m reads lives in registers:
//   its H and ne records of t - 1 ... t - 3, row m - 1's H of t - 3 ...
//   t - 6 (read once, at t - 3) and the three donor lists, kept in rank
//   order (the global variant threads a slot permutation through them)
//   so every register index is static; a list is read through selects
//   over the three.  An entry carries its donor's tables (dinc5, r1idx,
//   the A1 row) packed in one word, so a merge does not chase them.  The
//   per-position tables the rows read live in a ring of genome positions
//   in shared memory, loaded ahead by the CTA's first warp; the rows'
//   profile entries and the intron penalty table live there too, and
//   the penalty past that table comes from the wrapper's table by length
//   (built on the host with the scan engine's log; the global variant
//   and the plain version read the same table).
//   The warps run skewed by kSkew waves and meet at a split cluster
//   barrier every kEvery steps (see below), so a step has no barrier of
//   its own.  The barrier's acquire empties L1, which is why nothing the
//   steps read stays in global memory but the penalty tail and the
//   left-column and top-row records.
// - The global variant, past what 8 CTAs hold: one block, one thread a
//   row (rows m, m + blockDim, ... past 512 rows), every record a row
//   keeps across waves in a global scratch, field by field with the row
//   fastest, and one barrier a wave.
// The TPU layout devices (the (8, 128) row tile, flipped stride-3
// tables, lane rolls, pre-shifted ring copies, the select tree over
// profile columns) have no reason here.  The planes stay in device
// memory for K4w (csrc/spliced_h_walk.cu).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr float NEVSEL = -8.9e30f;
constexpr int DIAG = 2, NEWD = 3, VERT = 4, HORI = 8, SPIN = 16,
              SPJCI = 48;
constexpr int NCAND = 4, NSLOT = 5, INTR = 2, TSIMD = 26, NCOL = 13;
// the cluster variant: rows (threads) a CTA, CTAs a cluster (the
// portable most).  Its warps run skewed: warp g takes wave s - g * kSkew
// at step s, and the cluster barrier closes every kEvery steps.  Row m
// reads row m - 1's H and G records of wave t - 3 and its sj record of
// t - 6, written kSkew + 3 (+ 3) steps earlier: a barrier lies between
// as long as kEvery <= kSkew + 3.  A ring slot is overwritten kSkew +
// kEvery + 3 (+ 3) steps after its read at the earliest, so a barrier
// lies between that read and the write.
constexpr int kRowsMax = 256, kClusterMax = 8;
constexpr int kSkew = 1, kEvery = kSkew + 3;
constexpr int kHD = 8, kSD = 16;   // H and G ring depth, sj ring depth
static_assert(kHD >= kSkew + kEvery + 3 && kSD >= kSkew + kEvery + 6 &&
                  (kHD & (kHD - 1)) == 0 && (kSD & (kSD - 1)) == 0,
              "a ring slot must outlive its reads");
// shared words a row: the rings (H: 5 fields, G: 4, sj: 4) and the row's
// profile (TSIMD); then one more profile row, the position ring, the
// penalty table and pair53
constexpr int kRingWords = 9 * kHD + 4 * kSD, kRowWords = kRingWords + 26;
// The position ring: what a row reads at genome positions n - 2 ... n + 1
// (the tab columns, and pack_donor's tables), packed in kPosWords words a
// position, for the kPosRing positions around the CTA's rows.  The CTA's
// first warp loads kLoad positions every kLoad steps, kEvery steps ahead
// of their first use, so the loaded values reach the other warps through
// a barrier and every position a step reads is in the ring.
constexpr int kPosRing = 1024, kPosWords = 6, kLoad = 32;
constexpr int kSmemMax = 232448;
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
  const float* pext;     // (N + 2,) intron penalty by length
  const float* tabT;     // (NCOL, N + 2): tab, column-major (cluster)
  const int* A1T;        // (5, N + 1): A1, column-major (cluster)
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

// the cluster barrier, split: a row's ring writes are released at the
// arrive, and its neighbour's are acquired at the wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
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

// The global variant: one block, one thread a row (rows m, m +
// blockDim, ... past 512 rows), every record a row keeps across waves in
// a global scratch, one __syncthreads a wave.  The wrapper takes it past
// what a cluster holds.
__global__ void __launch_bounds__(512)
spliced_h_wave_global(Params p, int rpt) {
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
              fO = p.fprm[6], e1V = p.fprm[7], gap_wi = p.fprm[8];
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
  // the penalty table in [llmt, rlmt), else the wrapper's table by
  // length, as the cluster variant reads it
  auto penalty = [&](int len) -> float {
    if (len < 0) return gap_wi;
    if (len < p.llmt) return NEVSEL;
    return len < p.rlmt ? pen[len - p.llmt] : p.pext[min(len, N + 1)];
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


// An entry of a donor list carries what the acceptor reads at its donor
// position c: dinc5[c] (< 16), r1idx[c] (< 8) and the A1 row (5 codes <
// 32), packed in 4 + 3 + 25 bits.
__device__ int pack_donor(const Params& p, int c) {
  unsigned pk = (unsigned)p.dinc5[c] | ((unsigned)p.r1idx[c] << 4);
#pragma unroll
  for (int e = 0; e < 5; ++e)
    pk |= (unsigned)p.A1T[e * (p.N + 1) + c] << (7 + 5 * e);
  return (int)pk;
}

// Position q's words of the position ring: tab's integer columns (trn <
// 32, phs5 + 2 and phs3 + 2 < 8, e3idx < 8, dinc3 < 16), the A2 row (5
// codes < 32), pack_donor at q clamped to [0, N], then sigE, sig5mix and
// sss3; outside [0, N + 2) tab's fill.
__device__ void load_position(const Params& p, int* pr, int q) {
  const int TL = p.N + 2;
  float v[NCOL];
#pragma unroll
  for (int c = 0; c < NCOL; ++c)
    v[c] = (q >= 0 && q < TL) ? p.tabT[c * TL + q] : tfill(c);
  int a2 = 0;
#pragma unroll
  for (int r = 0; r < 5; ++r) a2 |= (int)v[C_A2 + r] << (5 * r);
  const int i = q & (kPosRing - 1);
  pr[i] = (int)v[C_TRN] | ((int)v[C_PHS5] + 2) << 5 |
          ((int)v[C_PHS3] + 2) << 8 | (int)v[C_E3] << 11 |
          (int)v[C_DINC3] << 14;
  pr[kPosRing + i] = a2;
  pr[2 * kPosRing + i] = pack_donor(p, min(max(q, 0), p.N));
  pr[3 * kPosRing + i] = __float_as_int(v[C_SIGE]);
  pr[4 * kPosRing + i] = __float_as_int(v[C_SIG5]);
  pr[5 * kPosRing + i] = __float_as_int(v[C_SSS3]);
}

// The cluster variant: one row a thread, a slab of consecutive rows a
// CTA, up to kClusterMax CTAs in one thread-block cluster.  The records
// row m + 1 reads live in the CTA's shared memory (row m = the last row
// of a slab is read by the next CTA through distributed shared memory);
// the records only row m reads, and its donor candidate lists, live in
// registers.  Every float operation is the global variant's, in its
// order, so the planes are equal bit for bit.
__global__ void __launch_bounds__(kRowsMax, 1)
spliced_h_wave_cluster(Params p) {
  extern __shared__ int sm[];
  const int R = blockDim.x;
  const int rank = (int)cg::this_cluster().block_rank();
  const int lm = threadIdx.x;
  const int m = rank * R + lm;
  const int M = p.M, N = p.N, lw = p.lw, up = p.up;
  const int off0 = 3 - lw, LL = off0, r0_max = min(up, N);
  const int t_min = 3 + max(3 + lw, 1);
  const int t_max = 3 * M + min(3 * M + up, N);
  const int W6 = up - lw + 7;
  const float gop = p.fprm[0], gep = p.fprm[1], gap_e1 = p.fprm[2],
              gap_e2 = p.fprm[3], gap_w1 = p.fprm[4], gap_w2 = p.fprm[5],
              fO = p.fprm[6], e1V = p.fprm[7], gap_wi = p.fprm[8];

  // shared words, field-major with the slab's row fastest: the H ring
  // (V, D, GA, GB, J; kHD waves), the G ring (V, D, GB, J; kHD waves),
  // the sj ring (V, D, J, K; kSD waves); then the profile rows of the
  // slab and the next row, the position ring, the penalty table and
  // pair53
  int* const Hr = sm;
  int* const Gr = sm + 5 * kHD * R;
  int* const Sr = sm + 9 * kHD * R;
  float* const qs = (float*)(sm + kRingWords * R);
  int* const pr = (int*)(qs + (R + 1) * TSIMD);
  float* const pen = (float*)(pr + kPosWords * kPosRing);
  float* const p53 = pen + p.npen;
  // row m - 1's words: this slab's, or the last row of the previous
  // CTA's slab (the same layout, through distributed shared memory)
  const int* nb = sm;
  if (lm > 0)
    nb = sm + lm - 1;
  else if (rank > 0)
    nb = cg::this_cluster().map_shared_rank(sm, rank - 1) + R - 1;

  for (int i = lm; i < 256; i += R) p53[i] = p.pair53[i];
  for (int i = lm; i < p.npen; i += R) pen[i] = p.pen[i];
  {
    const int m0 = rank * R;
    const int nq = min(R + 1, M + 2 - m0) * TSIMD;
    for (int i = lm; i < nq; i += R) qs[i] = p.qprof[m0 * TSIMD + i];
  }
  for (int s = 0; s < kHD; ++s) {
    Hr[s * R + lm] = __float_as_int(NEVSEL);
    Gr[s * R + lm] = __float_as_int(NEVSEL);
    for (int f = 1; f < 5; ++f) Hr[(f * kHD + s) * R + lm] = 0;
    for (int f = 1; f < 4; ++f) Gr[(f * kHD + s) * R + lm] = 0;
  }
  for (int s = 0; s < kSD; ++s) {
    Sr[s * R + lm] = __float_as_int(NEVSEL);
    for (int f = 1; f < 4; ++f) Sr[(f * kSD + s) * R + lm] = 0;
  }
  // the positions a step reads: warp g's rows at step s lie in
  // [s - g (kSkew + 96) - 95, s - g (kSkew + 96) + 1]; the CTA's first warp
  // g0 runs ahead, and its head at step s is s - g0 (kSkew + 96) + 1
  const int g0 = rank * R / 32;
  const int head0 = t_min - g0 * (kSkew + 96) + 1;
  for (int q = head0 + kEvery - kPosRing + 2 * kLoad + 1 + lm;
       q <= head0 + kEvery; q += R)
    load_position(p, pr, q);
  cluster_arrive();
  cluster_wait();

  auto pw = [&](int q, int f) -> int {
    return pr[f * kPosRing + (q & (kPosRing - 1))];
  };
  // row lm's and row lm + 1's profile entries
  const float* const q_m = qs + lm * TSIMD;
  const float* const q_m1 = q_m + TSIMD;
  auto api_at = [&](int i) -> float {
    return (i >= 0 && i < 3 * M + 4) ? p.api[i] : 0.0f;
  };
  auto h0rec = [&](int s) -> Rec {
    return Rec{p.h0v[s], p.h0i[s], p.h0i[W6 + s], p.h0i[2 * W6 + s],
               p.h0i[3 * W6 + s]};
  };
  auto top = [&](int c) -> Rec {
    return (c >= 0 && c <= r0_max) ? h0rec(off0 + c)
                                   : Rec{NEVSEL, 0, 0, 0, 0};
  };
  auto left = [&](int j) -> Rec {
    return (j >= 0 && j <= LL) ? h0rec(off0 - j) : Rec{0.0f, 0, 0, 0, 0};
  };
  // the penalty table in [llmt, rlmt), else the wrapper's table of the
  // plain version's penalty by length (a length is at most N: a donor
  // and an acceptor lie in [0, N])
  auto penalty = [&](int len) -> float {
    if (len < 0) return gap_wi;
    if (len < p.llmt) return NEVSEL;
    return len < p.rlmt ? pen[len - p.llmt] : p.pext[min(len, N + 1)];
  };
  const Rec guard{NEVSEL, 0, 0, 0, 0};

  const int nfm = max(3 * m + lw, 1), nlm = min(3 * m + up, N);
  const int nf1 = max(3 * (m - 1) + lw, 1), nl1 = min(3 * (m - 1) + up, N);
  const bool internal = !p.a_exgr || m < M;
  const float pua = internal ? gep : 0.0f;
  const float sig_m1 = api_at(3 * m - 1), sig_0 = api_at(3 * m),
              sig_p1 = api_at(3 * m + 1);

  // the row's own records: H at waves t - 1 ... t - 3, ne at t - 1 ...
  // t - 3; row m - 1's H at t - 3 ... t - 6 (read once, at t - 3)
  Rec o1 = guard, o2 = guard, o3 = guard;
  Rec e1 = guard, e2 = guard, e3 = guard;
  Rec q0 = guard, q1 = guard, q2 = guard, q3 = guard;
  // donor candidate lists by rank (slot k holds rank k): value, donor
  // position, lane | crossspj << 2, the donor's packed tables; and each
  // list's count
  float cV[3][NSLOT];
  int cJ[3][NSLOT], cDC[3][NSLOT], cPK[3][NSLOT], ncand[3];
  const int pk0 = pack_donor(p, 0);
#pragma unroll
  for (int L = 0; L < 3; ++L) {
    ncand[L] = 0;
#pragma unroll
    for (int j = 0; j < NSLOT; ++j) {
      cV[L][j] = NEVSEL;
      cJ[L][j] = 0;
      cDC[L][j] = 0;
      cPK[L][j] = pk0;
    }
  }

  // the skewed schedule: this warp's wave at step s is s - g * kSkew
  const int g = m >> 5;
  const int s_last = t_max + ((int)(gridDim.x * R) / 32 - 1) * kSkew;
  for (int s = t_min; s <= s_last; ++s) {
    const int ph = (s - t_min) % kEvery;
    const int t = s - g * kSkew;
    __syncwarp();
    if (ph == 0 && s > t_min) cluster_wait();
    if (g == g0 && (s - t_min) % kLoad == 0)
      load_position(p, pr, s - t_min + head0 + kEvery + 1 + (lm & 31));
    if (m > M || t < t_min || t > t_max) {
      if (ph == kEvery - 1) cluster_arrive();
      continue;
    }
    const int wi = t - t_min;
    const int n = t - 3 * m;
    const bool valid = m >= 1 && n >= nfm && n <= nlm;

    // ---- row m - 1's records: H of wave t - 3 (then held 3 waves), G
    // of t - 3, sj of t - 6
    q3 = q2;
    q2 = q1;
    q1 = q0;
    float gV_ = 0.0f, sjV_ = 0.0f;
    int gD_ = 0, gGB_ = 0, gJ_ = 0, sjD_ = 0, sjJ_n = 0, sjK_n = 0;
    {
      const int h = (t - 3) & (kHD - 1), j = (t - 6) & (kSD - 1);
      q0 = Rec{__int_as_float(nb[h * R]), nb[(kHD + h) * R],
               nb[(2 * kHD + h) * R], nb[(3 * kHD + h) * R],
               nb[(4 * kHD + h) * R]};
      gV_ = __int_as_float(nb[(5 * kHD + h) * R]);
      gD_ = nb[(6 * kHD + h) * R];
      gGB_ = nb[(7 * kHD + h) * R];
      gJ_ = nb[(8 * kHD + h) * R];
      sjV_ = __int_as_float(nb[(9 * kHD + j) * R]);
      sjD_ = nb[(9 * kHD + kSD + j) * R];
      sjJ_n = nb[(9 * kHD + 2 * kSD + j) * R];
      sjK_n = nb[(9 * kHD + 3 * kSD + j) * R];
    }

    // ---- the row's own part
    auto same = [&](int k, const Rec& r) -> Rec {
      const int nk = n - k;
      const bool use = nk >= nfm;
      Rec out = use ? r : guard;
      const int j = 3 * m - nk;
      if (!use && nk <= 0 && j >= 0 && j <= LL) out = left(j);
      return out;
    };
    const Rec b1 = same(1, o1), b2 = same(2, o2), b3 = same(3, o3);
    Rec eq = guard;
    if (n - 3 >= nfm) eq = Rec{e3.V, e3.D, e3.GA, 0, e3.J};
    if (t == p.e1pre_t && m == 1)
      eq = Rec{e1V, p.e1i[0], p.e1i[1], p.e1i[2], p.e1i[3]};
    const int w_m2 = pw(n - 2, 0), w_0 = pw(n, 0);
    const float sE = n >= 2 ? __int_as_float(pw(n - 2, 3)) : 0.0f;
    const float dv = q_m[w_m2 & 31] + sE;
    const int p3 = ((w_0 >> 8) & 7) - 2;
    const int p5 = ((w_0 >> 5) & 7) - 2;
    const int nxt_aa = n + 1 < N ? pw(n + 1, 0) & 31 : p.amb;
    const float qp1_nxt = q_m1[nxt_aa];

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

    // ---- row m - 1's records in the band
    // (m - 1, n - off), written at wave t - 3 - off; row 1 reads the
    // top-row init record; before the band, the left column
    auto below = [&](int off, const Rec& r) -> Rec {
      const int col = n - off;
      const bool ok = m >= 2 && col >= nf1 && col <= nl1;
      Rec out = ok ? r : guard;
      const int ii = 3 * (m - 1) - col;
      if (!ok && m >= 2 && col <= 0 && ii >= 0 && ii <= LL)
        out = left(6 * m - t - off);
      if (m == 1) out = top(t - 3 - off);
      return out;
    };
    const Rec hq = below(3, q3), f1 = below(2, q2), f2 = below(1, q1),
              f3 = below(0, q0);
    Rec gd = guard;
    float sjV = NEVSEL;
    int sjDv = 0, sjJ_ = 0, sjK_ = 0;
    if (m >= 2 && n >= nf1 && n <= nl1) gd = Rec{gV_, gD_, 0, gGB_, gJ_};
    if (m >= 2 && n - 3 >= nf1 && n - 3 <= nl1) {
      sjV = sjV_;
      sjDv = sjD_;
      sjJ_ = sjJ_n;
      sjK_ = sjK_n;
    }

    // ---- diagonal (or sj crossing)
    const bool sj_used = sjDv != 0 && n > 2;
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

    // ---- running max
    int w = gV > hV_ ? 2 : 0;
    float mxV = fmaxf(gV, hV_);
    if (neV >= mxV) w = 1;
    mxV = fmaxf(neV, mxV);

    // ---- 3' acceptor merges (per phase): phase 0 from list la0, phase
    // 1 (where p3 == 2) from list 2, as in the global variant.  A list is
    // read by rank through selects over the three, so every register
    // index stays static and a warp runs one phase body whatever lists
    // its rows use.
    bool jx[3] = {false, false, false};
    int jdon[3] = {0, 0, 0}, jnb[3] = {0, 0, 0};
    bool jcs0 = false;
    float lvV[3] = {hV_, neV, gV};
    float sj_nV = NEVSEL;
    int sj_nJ = 0, sj_nK = 0;
    bool sj_set = false, sj_clr = false;
    const bool has_acc = valid && internal && n < N && p3 != -2;
    auto acceptor = [&](const float (&V)[NCAND], const int (&J)[NCAND],
                        const int (&DC)[NCAND], const int (&PK)[NCAND],
                        int nc_li, int phs) {
      const int nb_ = n - phs;
      const bool is_p1 = phs == 1, is_m1 = phs == -1;
      const int cv = is_p1 ? n - 1 : is_m1 ? n + 1 : n;
      const int w_cv = pw(cv, 0), a2 = pw(cv, 1);
      const int dinc3v = (w_cv >> 14) & 15;
      const float sss3v = __int_as_float(pw(cv, 5));
      const int e3v = (w_cv >> 11) & 7;
      const float sigJ = is_p1 ? sig_m1 : is_m1 ? sig_p1 : sig_0;
      float xm[NCAND], y[NCAND];
      bool act[NCAND];
#pragma unroll
      for (int k = 0; k < NCAND; ++k) {
        const unsigned pk = (unsigned)PK[k];
        act[k] = k < nc_li;
        float v = V[k] + sigJ;
        v = v + penalty(nb_ - J[k]);
        v = v + p53[(pk & 15) * 16 + dinc3v];
        v = v + sss3v;
        const int aa1 = (pk >> (7 + 5 * e3v)) & 31;
        const float pm1 = (aa1 == p.trm || aa1 == p.trm2) ? fO : 0.0f;
        const float qa1 = q_m[aa1];
        v = v + (((DC[k] & 3) == 0 && is_p1) ? pm1 + qa1 : 0.0f);
        const int aa2 = (a2 >> (5 * ((pk >> 4) & 7))) & 31;
        const float pm2 = (aa2 == p.trm || aa2 == p.trm2) ? fO : 0.0f;
        float yk = v + pm2;
        yk = yk + q_m1[aa2];
        xm[k] = v;
        y[k] = yk;
      }
      // sj shadow: the last qualifying rank wins
      const float thr = mxV + qp1_nxt;
      bool any_sj = false;
      float yl = 0.0f;
      int jl = 0;
#pragma unroll
      for (int k = 0; k < NCAND; ++k)
        if (act[k] && (DC[k] & 3) == 0 && is_m1 && y[k] > thr) {
          any_sj = true;
          yl = y[k];
          jl = J[k];
        }
      if (any_sj) {
        sj_nV = yl;
        sj_nJ = nb_;
        sj_nK = jl + phs;
      }
      sj_set = sj_set || any_sj;
      // per-lane best candidate: the first rank reaching the max
      bool merged0 = false;
#pragma unroll
      for (int lane = 0; lane < 3; ++lane) {
        bool anyin = act[0] && (DC[0] & 3) == lane;
        float bx = anyin ? xm[0] : NEVSEL;
        int bJ = J[0], bC = DC[0];
#pragma unroll
        for (int k = 1; k < NCAND; ++k) {
          const bool inl = act[k] && (DC[k] & 3) == lane;
          const float v = inl ? xm[k] : NEVSEL;
          if (v > bx) {
            bJ = J[k];
            bC = DC[k];
            bx = v;
          }
          anyin = anyin || inl;
        }
        const bool better = anyin && bx > lvV[lane];
        if (better) {
          lvV[lane] = bx;
          jx[lane] = true;
          jdon[lane] = bJ + phs;
          jnb[lane] = nb_;
        }
        if (lane == 0) {
          if (better) jcs0 = (bC >> 2) != 0;
          merged0 = better;
        }
      }
      sj_clr = sj_clr || (is_m1 && merged0);
      mxV = w == 1 ? lvV[1] : w == 2 ? lvV[2] : lvV[0];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (jx[k] && lvV[k] > mxV) {
          w = k;
          mxV = lvV[k];
        }
    };
    if (has_acc) {
      const int pa0 = p3 == 2 ? -1 : p3;
      const int li = min(max(pa0 + 1, 0), 2);
      float V[NCAND];
      int J[NCAND], DC[NCAND], PK[NCAND];
#pragma unroll
      for (int k = 0; k < NCAND; ++k) {
        V[k] = li == 0 ? cV[0][k] : li == 1 ? cV[1][k] : cV[2][k];
        J[k] = li == 0 ? cJ[0][k] : li == 1 ? cJ[1][k] : cJ[2][k];
        DC[k] = li == 0 ? cDC[0][k] : li == 1 ? cDC[1][k] : cDC[2][k];
        PK[k] = li == 0 ? cPK[0][k] : li == 1 ? cPK[1][k] : cPK[2][k];
      }
      acceptor(V, J, DC, PK, li == 0 ? ncand[0] : li == 1 ? ncand[1]
                                                          : ncand[2], pa0);
    }
    if (has_acc && p3 == 2) {
      float V[NCAND];
      int J[NCAND], DC[NCAND], PK[NCAND];
#pragma unroll
      for (int k = 0; k < NCAND; ++k) {
        V[k] = cV[2][k];
        J[k] = cJ[2][k];
        DC[k] = cDC[2][k];
        PK[k] = cPK[2][k];
      }
      acceptor(V, J, DC, PK, ncand[2], 1);
    }
    // with no acceptor the global variant still takes the max again
    if (!has_acc) mxV = w == 1 ? lvV[1] : w == 2 ? lvV[2] : lvV[0];
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

    // ---- 5' donor pushes (per phase, lists as above).  A push of value
    // xp finds its rank pos among the first l_start entries, moves the
    // entry at rank l_start (the free or evicted one) to rank pos and
    // shifts ranks pos ... l_start - 1 down by one; an accepted push then
    // overwrites rank pos.  This is the global variant's slot
    // permutation, kept in rank order so every index is static.  An
    // entry carries its donor's dinc5, r1idx and A1 row, packed.
    const bool has_don = valid && internal && n < N && p5 != -2;
    const float lvV2[3] = {cVx, neV, gV};
    const int lvD2[3] = {cDx, neD, gD};
    const int hd = d2n(cDx);
    auto donor = [&](float (&V)[NSLOT], int (&J)[NSLOT], int (&DC)[NSLOT],
                     int (&PK)[NSLOT], int& ncl, int phs) {
      const int nb_ = n - phs;
      const bool is_p1 = phs == 1, is_m1 = phs == -1;
      const float sigJ = __int_as_float(pw(is_p1 ? n - 1 : is_m1 ? n + 1 : n, 4));
      const int pk_nb = pw(nb_, 2);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const bool cross = is_p1 && k == 0;
        bool ok = true;
        if (k == 0) ok = hd == 0 || is_p1;
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
#pragma unroll
        for (int j = 0; j < NCAND; ++j)
          if (j < l_start && V[j] >= xp) ++pos;
        float tV = V[0];
        int tJ = J[0], tC = DC[0], tP = PK[0];
#pragma unroll
        for (int j = 1; j < NSLOT; ++j)
          if (j == l_start) {
            tV = V[j];
            tJ = J[j];
            tC = DC[j];
            tP = PK[j];
          }
#pragma unroll
        for (int j = NSLOT - 1; j >= 1; --j)
          if (j > pos && j <= l_start) {
            V[j] = V[j - 1];
            J[j] = J[j - 1];
            DC[j] = DC[j - 1];
            PK[j] = PK[j - 1];
          }
        const bool accept = pos < INTR;
#pragma unroll
        for (int j = 0; j < NSLOT; ++j)
          if (j == pos) {
            V[j] = accept ? xp : tV;
            J[j] = accept ? nb_ : tJ;
            DC[j] = accept ? (k | (cross ? 4 : 0)) : tC;
            PK[j] = accept ? pk_nb : tP;
          }
        ncl = accept ? nc1 : nc1 - 1;
      }
    };
    if (has_don) {
      const int pd0 = p5 == 2 ? -1 : p5;
      const int li = min(max(pd0 + 1, 0), 2);
      float V[NSLOT];
      int J[NSLOT], DC[NSLOT], PK[NSLOT];
#pragma unroll
      for (int j = 0; j < NSLOT; ++j) {
        V[j] = li == 0 ? cV[0][j] : li == 1 ? cV[1][j] : cV[2][j];
        J[j] = li == 0 ? cJ[0][j] : li == 1 ? cJ[1][j] : cJ[2][j];
        DC[j] = li == 0 ? cDC[0][j] : li == 1 ? cDC[1][j] : cDC[2][j];
        PK[j] = li == 0 ? cPK[0][j] : li == 1 ? cPK[1][j] : cPK[2][j];
      }
      int ncl = li == 0 ? ncand[0] : li == 1 ? ncand[1] : ncand[2];
      donor(V, J, DC, PK, ncl, pd0);
#pragma unroll
      for (int L = 0; L < 3; ++L)
        if (li == L) {
#pragma unroll
          for (int j = 0; j < NSLOT; ++j) {
            cV[L][j] = V[j];
            cJ[L][j] = J[j];
            cDC[L][j] = DC[j];
            cPK[L][j] = PK[j];
          }
          ncand[L] = ncl;
        }
    }
    if (has_don && p5 == 2) donor(cV[2], cJ[2], cDC[2], cPK[2], ncand[2], 1);

    // ---- the records row m + 1 reads, then the barrier's arrival
    {
      const int h = t & (kHD - 1), j = t & (kSD - 1);
      Hr[h * R + lm] = __float_as_int(cVx);
      Hr[(kHD + h) * R + lm] = cDx;
      Hr[(2 * kHD + h) * R + lm] = cGAx;
      Hr[(3 * kHD + h) * R + lm] = cGBx;
      Hr[(4 * kHD + h) * R + lm] = cJx;
      Gr[h * R + lm] = __float_as_int(gV);
      Gr[(kHD + h) * R + lm] = gD;
      Gr[(2 * kHD + h) * R + lm] = gGB;
      Gr[(3 * kHD + h) * R + lm] = gJ;
      Sr[j * R + lm] = __float_as_int(sj_on ? sj_nV : NEVSEL);
      Sr[(kSD + j) * R + lm] = sj_on ? NEWD : 0;
      Sr[(2 * kSD + j) * R + lm] = sj_on ? sj_nJ : 0;
      Sr[(3 * kSD + j) * R + lm] = sj_on ? sj_nK : 0;
    }
    if (ph == kEvery - 1) cluster_arrive();
    o3 = o2;
    o2 = o1;
    o1 = Rec{cVx, cDx, cGAx, cGBx, cJx};
    e3 = e2;
    e2 = e1;
    e1 = Rec{neV, neD, neGA, 0, neJ};

    // ---- planes
    const int evv = w | (sj_used ? EVH_SJ : 0) | (vk << 3) | (hk << 5) |
                    (jx[0] ? EVH_JXH : 0) | (jx[1] ? EVH_JXF : 0) |
                    (jx[2] ? EVH_JXG : 0) | (jcs0 ? EVH_CSH : 0);
    const int MR = M + 1;
    const size_t o = (size_t)wi * MR + m;
    p.ev[o] = valid ? evv : -1;
    p.Vp[o] = cVx;
    p.Dp[o] = cDx;
    const size_t oj = (size_t)wi * 4 * MR + m;
    p.jd[oj] = jdon[0];
    p.jd[oj + MR] = jdon[1];
    p.jd[oj + 2 * MR] = jdon[2];
    p.jd[oj + 3 * MR] = sj_used ? sjK_ : 0;
  }
  // no CTA leaves while the next one may still read its rings
  if ((s_last - t_min) % kEvery != kEvery - 1) cluster_arrive();
  cluster_wait();
}

}  // namespace

// Words of scratch a row of the global variant needs: H ring 8 x 5, ne
// and G rings 4 x 4 each, sj ring 8 x 4, candidate lists 5 x 3 x NSLOT,
// counts 3.  The wrapper allocates this many times M + 1.
extern "C" int spliced_h_wave_scratch_words() {
  return 8 * 5 + 4 * 4 + 4 * 4 + 8 * 4 + 5 * 3 * NSLOT + 3;
}

// ``cluster`` picks the variant, chosen by size by the wrapper
// (ops/spliced_h.py::sweep_plan): 1, ``ctas`` CTAs of ``threads`` rows in
// one cluster, reading ``tab`` and ``A1`` column-major from ``tabT``
// and ``A1T``; 0, one block of ``threads`` threads, ``rpt`` rows each,
// over the global scratch ``ring``.  Both read the penalty of a length
// past the table from ``pext``, the wrapper's table by length.  A launch either variant refuses
// returns its error; neither stands in for the other.
extern "C" int spliced_h_wave_launch(
    const void* tab, const void* dinc5, const void* r1idx, const void* A1,
    const void* pair53, const void* qprof, const void* api, const void* pen,
    const void* h0v, const void* h0i, const void* e1i, const void* fprm,
    const void* pext, const void* tabT, const void* A1T, void* ring,
    void* ev, void* jd, void* V, void* D,
    int M, int N, int lw, int up, int a_exgr, int e1pre_t, int llmt,
    int rlmt, int trm, int trm2, int amb, int cluster, int ctas,
    int threads, int rpt, void* stream) {
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
  p.pext = (const float*)pext;
  p.tabT = (const float*)tabT;
  p.A1T = (const int*)A1T;
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
  cudaStream_t s = (cudaStream_t)stream;
  const size_t tables = (size_t)(p.npen + 256) * sizeof(float);
  if (!cluster) {
    if (tables > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        spliced_h_wave_global, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tables);
    if (err != cudaSuccess) return (int)err;
    spliced_h_wave_global<<<1, threads, tables, s>>>(p, rpt);
    return (int)cudaGetLastError();
  }
  const size_t smem = ((size_t)kRowWords * threads + TSIMD +
                       kPosWords * kPosRing + p.npen + 256) * sizeof(int);
  if (ctas < 1 || ctas > kClusterMax || threads < 1 || threads > kRowsMax ||
      (size_t)ctas * threads < (size_t)M + 1 || smem > (size_t)kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      spliced_h_wave_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, spliced_h_wave_cluster, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Registers a thread and local (spilled) bytes of a variant.
extern "C" int spliced_h_wave_attrs(int cluster, void* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cluster ? cudaFuncGetAttributes(&a, spliced_h_wave_cluster)
              : cudaFuncGetAttributes(&a, spliced_h_wave_global);
  if (err != cudaSuccess) return (int)err;
  int* o = (int*)out;
  o[0] = a.numRegs;
  o[1] = (int)a.localSizeBytes;
  return 0;
}
