// Kernel K5: the fwd2s forward sweep (a cDNA against genomic DNA with
// introns), one wave t = 2i + s per step.
//
// Replaces prrn_aln_tpu/ops/spliced_jax.py::_sweep (:73), the lax.scan
// engine behind spliced_align_device (there is no Pallas kernel on this
// path).  Its plain version is ops/spliced_s.py::sweep_s_ref; both run
// the scan engine's float operations in its order (built with
// -fmad=false, and the intron penalty read from the wrapper's table by
// length), so their planes are equal.
//
// The work: one dependent chain of 2 * rows + W - 2 waves.  At a wave
// every cDNA row i (m = m_start + i) takes the cell of its slot
// s = t - 2i, which reads row i - 1's H record at slots s (wave t - 2)
// and s + 1 (wave t - 1) and its G record at the same slots, and its own
// row's horizontal carry: the f1 lane, the previous cell's record and the
// donor candidate list (NCAND = 4 ranks over 5 entries).  At an acceptor
// site it merges up to 4 candidates (three adds each: penalty, pair53,
// sss3), at a donor site it pushes up to 3 lanes through the list's
// insertion sort: tens to some hundreds of scalar operations a cell, with
// branches that differ from row to row.  The bytes it must write are 16
// a cell (ev and jdon), 0.67 GB for a 2.2 kb cDNA against a 19 kb locus,
// about 0.2 ms at the card's memory rate; the chain of waves bounds it far
// above that.
//
// What bounds it on the H100: the latency of one wave, times the waves.
// Three variants, chosen by size (ops/spliced_s.py::sweep_s_plan):
// - The cluster variant, up to 16 CTAs of up to 256 rows (4,096 rows):
//   one row a thread, a slab of consecutive rows a CTA, the CTAs one
//   thread-block cluster, so a wave's rows run on up to 16 SMs.  A row's
//   horizontal carry lives in registers, its donor list in rank order
//   (every register index static), each entry with its donor's dinc5
//   beside its position.  Only what row i + 1 reads is passed on: the H
//   and G records of wave t - 1, by __shfl_up_sync inside a warp (row
//   i + 1 keeps the one of wave t - 2 from the step before), and through
//   a small ring in shared memory from a warp's last row to the next
//   warp's first (the first warp of a slab reads the previous CTA's
//   ring through distributed shared memory).  The warps run skewed by
//   kSkew waves and meet at a split cluster barrier every kSkew + 1
//   steps, so a wave has no barrier of its own (skew 7 timed fastest of
//   1, 3, 5 and 7; waits on each warp's neighbours alone, through
//   progress counters, timed slower: PERF.md §6).  Shared memory holds
//   the matrix, pair53, a ring of genome positions (the per-position
//   tables packed in three words, loaded ahead by the slab's first warp)
//   and, where it fits, the penalty table by length.  The barrier's
//   acquire empties L1: past what shared memory takes (a genome past
//   ~54 kb), the penalty table is read from device memory.
// - The chained variant, past what one cluster holds (a matrix of at
//   most 256 codes): clusters of the cluster variant's shape over
//   consecutive slabs of rows, each running one cluster's schedule from
//   the wave its first row starts at, so the warps' skew carries on from
//   cluster to cluster.  A cluster's first row reads the last row of the
//   cluster before through a column in device memory, an entry a wave,
//   behind a progress counter (release and acquire at gpu scope; see
//   column_stage).  The clusters of a launch wait on each other, so a
//   launch holds at most what cudaOccupancyMaxActiveClusters finds room
//   for; past that the slabs run in passes, one launch each, a pass's
//   first cluster reading the column the last pass finished.  A reader
//   that waited for 0 to 128 waves more than it needs timed within
//   0.4 % on the long, realistic and medium genes (512: ~1 % slower), so
//   it waits for what it needs and no more; a cluster stalled for
//   kStall cycles traps.  Fewer rows a CTA take a step sooner, so the
//   plan spreads the rows to 64 a CTA over as many clusters as the card
//   holds at once (the long gene: 57.3 ms as 7 x 14 CTAs x 64 rows, 58.1
//   as 5 x 13 x 96, 59.4 as 4 x 13 x 128, 71.2 as 2 x 14 x 224; one pass
//   more costs a pass's waves: 2 passes of 7 and 3 clusters 93.5 ms;
//   tools/k5_bench.py, PERF.md §6).  Built apart (kChain) so that the
//   one-cluster kernel carries no column code.
// - The global variant, for a matrix past 256 codes (and the bench and
//   the tests): one block, rows spread over at most 1,024 threads (rows
//   i, i + blockDim, ...), one __syncthreads a wave; a row keeps its
//   horizontal carry in registers when its thread has one row, and in a
//   global scratch (field by field, the row fastest) otherwise; each row
//   keeps a ring of its last three waves' H (V, D, GA, GB, J) and G (V,
//   GA, GB, J) records, in shared memory where they fit, else in the
//   global scratch (a slot is overwritten three waves after its write,
//   one barrier after its last read); the match score is gathered from
//   the DNA matrix in shared memory, with pair53 beside it and the
//   penalty table where it fits; the genome-position tables are read
//   through the read-only cache.
// All write ev (rows, W), jdon (rows, W, 3) and the last row's H
// records, which the host's lastS and traceback read.  Built with
// -DK5_PROFILE, each thread sums clock64() cycles by section of a step
// (tools/k5_bench.py --profile).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr float NEVSEL = -8.9e30f;
constexpr int DEAD = 0, DIAG = 2, NEWD = 3, VERT = 4, HORI = 8, SPIN = 16,
              SPJCI = 48;
constexpr int NCAND = 4, NSLOT = NCAND + 1, INTR = 2;
constexpr int EV_VNEW = 1 << 2, EV_HNEW = 1 << 3, EV_JXH = 1 << 4,
              EV_JXF = 1 << 5, EV_JXG = 1 << 6;
// a ring slot: H's 5 fields, then G's V, GA, GB, J; three slots a row
constexpr int kRecWords = 9, kRingSlots = 3;
constexpr int kRingWords = kRecWords * kRingSlots;
// a row's horizontal carry in the scratch: f1 (V, D, GA, J; its GB is
// always 0), hp (V, D, GA, GB, J), hlV, hlJ, hlD, nx (5 each), ncand
constexpr int kStateWords = 4 + 5 + 4 * NSLOT + 1;
constexpr int kThreadsMax = 1024;
constexpr int kSmemMax = 232448;

// sections of a step (tools/k5_bench.py PROFILE_SECTIONS): the row
// above's records (and a carry from the scratch), the match score, the
// diagonal, vertical and horizontal candidates and their maximum, the
// acceptor merges, the donor pushes, the plane stores, the records row
// i + 1 reads (and a carry back to the scratch), the barrier, and the
// wait of a row without a cell while the others take theirs
enum {
  kSecRead, kSecMatch, kSecDVH, kSecAcc, kSecDon, kSecPlanes, kSecRing,
  kSecWait, kSecIdle, kSections
};
#ifdef K5_PROFILE
// per section the cycles summed over threads, then the threads' steps
__device__ unsigned long long k5_prof[kSections + 1];
__device__ __forceinline__ long long prof_clock() {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c));
  return c;
}
struct Prof {
  long long t, acc[kSections];
  __device__ Prof() : t(prof_clock()) {
    for (int k = 0; k < kSections; ++k) acc[k] = 0;
  }
  __device__ void mark(int sec) {
    const long long now = prof_clock();
    acc[sec] += now - t;
    t = now;
  }
  __device__ void flush(long long steps) {
    for (int k = 0; k < kSections; ++k)
      atomicAdd(&k5_prof[k], (unsigned long long)acc[k]);
    atomicAdd(&k5_prof[kSections], (unsigned long long)steps);
  }
};
#else
struct Prof {
  __device__ void mark(int) {}
  __device__ void flush(long long) {}
};
#endif

struct Params {
  const int* a;          // (la,) cDNA codes
  const int* b;          // (lb,) genome codes
  const float* mtx;      // (K, K)
  const int* cano3;      // (lb + 1,)
  const int* cano5;
  const float* sig5;
  const int* dinc5;
  const int* dinc3;
  const float* sss3;
  const float* pair53;   // (16, 16)
  const float* pen;      // (lb + 2,) penalty by length
  const float* h0v;      // (W + 2,)
  const int* h0i;        // (4, W + 2): D, GA, GB, J
  const float* g0v;
  const int* g0i;
  const float* fprm;     // gop, gep
  int* scratch;          // rings (unless in shared memory), then carries;
                         // chained: the boundaries' counters, then columns
  int* ev;               // (rows, W)
  int* jdon;             // (rows, W, 3)
  float* HV;             // (W + 2,): the last row's H, slots 1..W
  int* Hi;               // (4, W + 2)
  int la, lb, lw, up, a_exgl, a_exgr, K, rows, W, ring_smem, pen_smem;
  // the cluster variant: CTAs a cluster, clusters in all, this launch's
  // first cluster
  int ctas, nclus, c0;
};

// the row's horizontal carry
struct Carry {
  float f1V;
  int f1D, f1GA, f1J;
  float hpV;
  int hpD, hpGA, hpGB, hpJ;
  float hlV[NSLOT];
  int hlJ[NSLOT], hlD[NSLOT], nx[NSLOT];
  int ncand;
};

__device__ __forceinline__ bool is_diag(int d) {
  d &= 15;
  return d == DIAG || d == NEWD;
}
__device__ __forceinline__ bool is_vert(int d) {
  d &= 15;
  return (d >= 4 && d <= 7) || d == 12;
}
__device__ __forceinline__ bool is_hori(int d) {
  d &= 15;
  return (d >= 8 && d <= 11) || d == 13;
}
// spliced_np.DIR2NOD: the lane a direction's record came from
__device__ __forceinline__ int dir2nod(int d) {
  d &= 15;
  if (d == 2 || d == 3) return 0;
  if ((d >= 4 && d <= 6) || d == 12) return 2;
  if (d == 7) return 4;
  if ((d >= 8 && d <= 10) || d == 13) return 1;
  if (d == 11) return 3;
  return -1;
}

// entry k of a five-entry list held in registers (static indices only)
template <typename T>
__device__ __forceinline__ T sel5(const T (&x)[NSLOT], int k) {
  T v = x[0];
#pragma unroll
  for (int j = 1; j < NSLOT; ++j) v = k == j ? x[j] : v;
  return v;
}
template <typename T>
__device__ __forceinline__ void set5(T (&x)[NSLOT], int k, T v) {
#pragma unroll
  for (int j = 0; j < NSLOT; ++j)
    if (k == j) x[j] = v;
}

__device__ __forceinline__ void carry_init(Carry& c, const Params& p) {
  c.f1V = NEVSEL;
  c.f1D = c.f1GA = c.f1J = 0;
  const int W2 = p.W + 2;
  c.hpV = p.h0v[0];
  c.hpD = p.h0i[0];
  c.hpGA = p.h0i[W2];
  c.hpGB = p.h0i[2 * W2];
  c.hpJ = p.h0i[3 * W2];
#pragma unroll
  for (int j = 0; j < NSLOT; ++j) {
    c.hlV[j] = NEVSEL;
    c.hlJ[j] = 0;
    c.hlD[j] = 0;
    c.nx[j] = j;
  }
  c.ncand = 0;
}

// the carry of row i in the scratch, word w at st[w * rows + i]
__device__ __forceinline__ void carry_load(Carry& c, const int* st, int R) {
  c.f1V = __int_as_float(st[0]);
  c.f1D = st[R];
  c.f1GA = st[2 * R];
  c.f1J = st[3 * R];
  c.hpV = __int_as_float(st[4 * R]);
  c.hpD = st[5 * R];
  c.hpGA = st[6 * R];
  c.hpGB = st[7 * R];
  c.hpJ = st[8 * R];
#pragma unroll
  for (int j = 0; j < NSLOT; ++j) {
    c.hlV[j] = __int_as_float(st[(9 + j) * R]);
    c.hlJ[j] = st[(9 + NSLOT + j) * R];
    c.hlD[j] = st[(9 + 2 * NSLOT + j) * R];
    c.nx[j] = st[(9 + 3 * NSLOT + j) * R];
  }
  c.ncand = st[(9 + 4 * NSLOT) * R];
}

__device__ __forceinline__ void carry_store(const Carry& c, int* st, int R) {
  st[0] = __float_as_int(c.f1V);
  st[R] = c.f1D;
  st[2 * R] = c.f1GA;
  st[3 * R] = c.f1J;
  st[4 * R] = __float_as_int(c.hpV);
  st[5 * R] = c.hpD;
  st[6 * R] = c.hpGA;
  st[7 * R] = c.hpGB;
  st[8 * R] = c.hpJ;
#pragma unroll
  for (int j = 0; j < NSLOT; ++j) {
    st[(9 + j) * R] = __float_as_int(c.hlV[j]);
    st[(9 + NSLOT + j) * R] = c.hlJ[j];
    st[(9 + 2 * NSLOT + j) * R] = c.hlD[j];
    st[(9 + 3 * NSLOT + j) * R] = c.nx[j];
  }
  st[(9 + 4 * NSLOT) * R] = c.ncand;
}

// one cell: row i at slot s, wave t (spliced_jax._sweep's cell body)
__device__ __forceinline__ void cell(const Params& p, Carry& c, int i, int s,
                                     int t, const float* mtx,
                                     const float* p53, const float* pen,
                                     int* ring, Prof& pf) {
  const int R = p.rows, W = p.W, W2 = W + 2;
  const int m = i + (p.a_exgl ? 1 : 0);
  const int n = m + p.lw + s - 1;
  const bool valid = n >= max(m + p.lw, 1) && n <= min(m + p.up, p.lb);
  const bool internal = !p.a_exgr || m < p.la;
  const float gop = p.fprm[0], gep = p.fprm[1];
  const float pua = internal ? gep : 0.f;
  const bool no_diag = m == 0;

  // row i - 1 at slot s (wave t - 2) and s + 1 (wave t - 1): the ring, or
  // the init records for row 0 and for slot W + 1
  float dV, uV, gdV, guV;
  int dD, dGA, dGB, dJ, uD, uGA, uGB, uJ, gdGA, gdGB, gdJ, guGA, guGB, guJ;
  if (i == 0) {
    dV = p.h0v[s];
    dD = p.h0i[s];
    dGA = p.h0i[W2 + s];
    dGB = p.h0i[2 * W2 + s];
    dJ = p.h0i[3 * W2 + s];
    gdV = p.g0v[s];
    gdGA = p.g0i[W2 + s];
    gdGB = p.g0i[2 * W2 + s];
    gdJ = p.g0i[3 * W2 + s];
  } else {
    const int* r = ring + ((t - 2) % kRingSlots) * kRecWords * R + i - 1;
    dV = __int_as_float(r[0]);
    dD = r[R];
    dGA = r[2 * R];
    dGB = r[3 * R];
    dJ = r[4 * R];
    gdV = __int_as_float(r[5 * R]);
    gdGA = r[6 * R];
    gdGB = r[7 * R];
    gdJ = r[8 * R];
  }
  if (i == 0 || s == W) {
    const int su = s + 1;
    uV = p.h0v[su];
    uD = p.h0i[su];
    uGA = p.h0i[W2 + su];
    uGB = p.h0i[2 * W2 + su];
    uJ = p.h0i[3 * W2 + su];
    guV = p.g0v[su];
    guGA = p.g0i[W2 + su];
    guGB = p.g0i[2 * W2 + su];
    guJ = p.g0i[3 * W2 + su];
  } else {
    const int* r = ring + ((t - 1) % kRingSlots) * kRecWords * R + i - 1;
    uV = __int_as_float(r[0]);
    uD = r[R];
    uGA = r[2 * R];
    uGB = r[3 * R];
    uJ = r[4 * R];
    guV = __int_as_float(r[5 * R]);
    guGA = r[6 * R];
    guGB = r[7 * R];
    guJ = r[8 * R];
  }
  pf.mark(kSecRead);
  float bscr = 0.f;
  if (p.la > 0) {
    const int am = __ldg(p.a + max(m - 1, 0));
    const int bn = __ldg(p.b + min(max(n - 1, 0), p.lb - 1));
    bscr = mtx[am * p.K + bn];
  }
  pf.mark(kSecMatch);

  // ---- diagonal ----
  float hV = dV + bscr;
  int hD = is_diag(dD) ? DIAG : NEWD;
  int hJ = dJ;
  if (no_diag) {
    hV = NEVSEL;
    hD = DEAD;
  }

  // ---- vertical ----
  const float gopv = uGA >= uGB ? gop : 0.f;
  const float gnpv = guGA >= guGB ? gop : 0.f;
  const float vu = uV + gopv, vg = guV + gnpv;
  bool vnew = !is_vert(uD) && vu > vg;
  float gV = (vnew ? vu : vg) + pua;
  int gJ = vnew ? uJ : guJ;
  const int gGB = (vnew ? uGB : guGB) + 1;
  int gD = VERT;
  if (no_diag) {
    gV = NEVSEL;
    vnew = false;
  }

  // ---- horizontal ----
  const float goph = c.hpGA <= c.hpGB ? gop : 0.f;
  const float hh = c.hpV + goph;
  const bool hnew = !is_hori(c.hpD) && hh > c.f1V;
  float nf1V = (hnew ? hh : c.f1V) + gep;
  int nf1J = hnew ? c.hpJ : c.f1J;
  const int nf1GA = (hnew ? c.hpGA : c.f1GA) + 1;
  int nf1D = ((hnew ? c.hpD : c.f1D) & SPIN) + HORI;

  // ---- running max (h -> g strict -> f1 ties) ----
  int w = 0;
  float mxV = hV;
  if (gV > mxV) w = 2;
  mxV = gV > mxV ? gV : mxV;
  if (nf1V >= mxV) w = 1;
  mxV = nf1V > mxV ? nf1V : mxV;
  pf.mark(kSecDVH);

  // ---- 3' acceptor: merge candidates ----
  const int nc = min(max(n, 0), p.lb);
  float lv0 = hV, lv1 = nf1V, lv2 = gV;
  bool jx0 = false, jx1 = false, jx2 = false;
  int jd0 = 0, jd1 = 0, jd2 = 0;
  if (valid && internal && __ldg(p.cano3 + nc) > 0) {
    const int d3 = __ldg(p.dinc3 + nc);
    const float s3 = __ldg(p.sss3 + nc);
#pragma unroll
    for (int l = 0; l < NCAND; ++l) {
      if (l < c.ncand) {
        const int idx = c.nx[l];
        const int cj = sel5(c.hlJ, idx);
        float x = sel5(c.hlV, idx) + pen[min(max(n - cj, 0), p.lb + 1)];
        x = x + p53[16 * __ldg(p.dinc5 + min(max(cj, 0), p.lb)) + d3];
        x = x + s3;
        const int lane = min(max(sel5(c.hlD, idx), 0), 2);
        if (lane == 0 && x > lv0) {
          lv0 = x;
          jx0 = true;
          jd0 = cj;
        } else if (lane == 1 && x > lv1) {
          lv1 = x;
          jx1 = true;
          jd1 = cj;
        } else if (lane == 2 && x > lv2) {
          lv2 = x;
          jx2 = true;
          jd2 = cj;
        }
      }
    }
  }
  hV = lv0;
  nf1V = lv1;
  gV = lv2;
  if (jx0) {
    hD |= SPJCI;
    hJ = n;
  }
  if (jx1) {
    nf1D |= SPJCI;
    nf1J = n;
  }
  if (jx2) {
    gD |= SPJCI;
    gJ = n;
  }
  // merged lanes contest the max strictly, in lane order
  mxV = w == 0 ? lv0 : (w == 1 ? lv1 : lv2);
  if (jx0 && lv0 > mxV) {
    w = 0;
    mxV = lv0;
  }
  if (jx1 && lv1 > mxV) {
    w = 1;
    mxV = lv1;
  }
  if (jx2 && lv2 > mxV) {
    w = 2;
    mxV = lv2;
  }

  // ---- the cell record (h <- mx) ----
  const float cV = w == 0 ? hV : (w == 1 ? nf1V : gV);
  const int cD = w == 0 ? hD : (w == 1 ? nf1D : gD);
  const int cGA = w == 1 ? nf1GA : 0;
  const int cGB = w == 2 ? gGB : 0;
  const int cJ = w == 0 ? hJ : (w == 1 ? nf1J : gJ);
  pf.mark(kSecAcc);

  // ---- 5' donor: push candidates ----
  if (valid && internal && __ldg(p.cano5 + nc) > 0) {
    const int hd = dir2nod(cD);
    const float sj = __ldg(p.sig5 + nc);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int fD = k == 0 ? cD : (k == 1 ? nf1D : gD);
      const float fV = k == 0 ? cV : (k == 1 ? nf1V : gV);
      bool ok = (k != 0 || hd == 0) && fD != 0 && (fD & SPIN) == 0;
      const bool thr_on = k != hd && hd >= 0 && k != 0;
      const float y =
          mxV + ((hd == 0 || ((k - hd) % 2) != 0) ? (k == 2 ? gop : 0.f)
                                                   : 0.f);
      if (thr_on) ok = ok && fV > y;
      if (!ok) continue;
      const float x = fV + sj;
      // insertion sort over ranks (fwd2s.h:362 semantics)
      const int ncand_new = min(c.ncand + 1, NCAND);
      const int l_start = c.ncand < NCAND ? c.ncand + 1 : NCAND;
      int pos = 0;
      bool broken = false;
#pragma unroll
      for (int l = NCAND - 1; l >= 0; --l) {
        const bool active = l < l_start && !broken;
        const bool gt = x > sel5(c.hlV, c.nx[l]);
        if (active && gt) {
          const int tmp = c.nx[l];
          c.nx[l] = c.nx[l + 1];
          c.nx[l + 1] = tmp;
        }
        if (active && !gt) {
          pos = l + 1;
          broken = true;
        }
      }
      const bool accept = pos < INTR;
      if (accept) {
        const int slot = pos == 0 ? c.nx[0] : c.nx[1];
        set5(c.hlV, slot, x);
        set5(c.hlJ, slot, n);
        set5(c.hlD, slot, k);
      }
      c.ncand = accept ? ncand_new : ncand_new - 1;
    }
  }
  pf.mark(kSecDon);

  const size_t cellx = (size_t)i * W + (s - 1);
  const int e = w | (vnew ? EV_VNEW : 0) | (hnew ? EV_HNEW : 0) |
                (jx0 ? EV_JXH : 0) | (jx1 ? EV_JXF : 0) | (jx2 ? EV_JXG : 0);
  p.ev[cellx] = valid ? e : -1;
  p.jdon[3 * cellx] = jd0;
  p.jdon[3 * cellx + 1] = jd1;
  p.jdon[3 * cellx + 2] = jd2;
  pf.mark(kSecPlanes);

  // retain old values on invalid slots
  const float oV = valid ? cV : dV;
  const int oD = valid ? cD : dD, oGA = valid ? cGA : dGA,
            oGB = valid ? cGB : dGB, oJ = valid ? cJ : dJ;
  int* r = ring + (t % kRingSlots) * kRecWords * R + i;
  r[0] = __float_as_int(oV);
  r[R] = oD;
  r[2 * R] = oGA;
  r[3 * R] = oGB;
  r[4 * R] = oJ;
  r[5 * R] = __float_as_int(valid ? gV : gdV);
  r[6 * R] = valid ? 0 : gdGA;
  r[7 * R] = valid ? gGB : gdGB;
  r[8 * R] = valid ? gJ : gdJ;
  c.hpV = oV;
  c.hpD = oD;
  c.hpGA = oGA;
  c.hpGB = oGB;
  c.hpJ = oJ;
  if (valid) {
    c.f1V = nf1V;
    c.f1D = nf1D;
    c.f1GA = nf1GA;
    c.f1J = nf1J;
  }
  if (i == R - 1) {
    p.HV[s] = oV;
    p.Hi[s] = oD;
    p.Hi[W2 + s] = oGA;
    p.Hi[2 * W2 + s] = oGB;
    p.Hi[3 * W2 + s] = oJ;
  }
}

// kOne: one row a thread, its carry in registers; otherwise ``rpt`` rows
// a thread, their carries in the scratch
template <bool kOne>
__global__ void __launch_bounds__(kThreadsMax)
    spliced_s_wave_kernel(Params p, int rpt) {
  extern __shared__ float smem[];
  const int R = p.rows, K = p.K;
  float* mtx = smem;
  float* p53 = mtx + K * K;
  float* rest = p53 + 256;
  int* ring = p.ring_smem ? (int*)rest : p.scratch;
  if (p.ring_smem) rest += kRingWords * R;
  const float* pen = p.pen;
  if (p.pen_smem) {
    for (int k = threadIdx.x; k < p.lb + 2; k += blockDim.x)
      rest[k] = p.pen[k];
    pen = rest;
  }
  for (int k = threadIdx.x; k < K * K; k += blockDim.x) mtx[k] = p.mtx[k];
  for (int k = threadIdx.x; k < 256; k += blockDim.x) p53[k] = p.pair53[k];
  int* carries = p.scratch + (p.ring_smem ? 0 : kRingWords * R);
  Prof pf;
  Carry c;
  if (kOne) {
    carry_init(c, p);
  } else {
    for (int i = threadIdx.x; i < R; i += blockDim.x) {
      carry_init(c, p);
      carry_store(c, carries + i, R);
    }
  }
  __syncthreads();
  const int T = 2 * (R - 1) + p.W;
  for (int t = 1; t <= T; ++t) {
    if (kOne) {
      const int i = threadIdx.x, s = t - 2 * i;
      if (i < R && s >= 1 && s <= p.W) {
        cell(p, c, i, s, t, mtx, p53, pen, ring, pf);
        pf.mark(kSecRing);
      }
    } else {
      for (int j = 0; j < rpt; ++j) {
        const int i = threadIdx.x + j * blockDim.x, s = t - 2 * i;
        if (i >= R || s < 1 || s > p.W) continue;
        carry_load(c, carries + i, R);
        cell(p, c, i, s, t, mtx, p53, pen, ring, pf);
        carry_store(c, carries + i, R);
        pf.mark(kSecRing);
      }
    }
    pf.mark(kSecIdle);
    __syncthreads();
    pf.mark(kSecWait);
  }
  pf.flush(T);
}

// ---------------------------------------------------------------------
// The cluster variant
// ---------------------------------------------------------------------

// rows (threads) a CTA and CTAs a cluster (the non-portable most)
constexpr int kRowsMaxC = 256, kClusterMax = 16;
// The warps run skewed: warp g (counted over the cluster) takes wave
// s - g * kSkew at step s, and the cluster barrier closes every kSkew + 1
// steps.  A warp's first row reads the previous warp's last row's
// records of wave t - 1, written kSkew + 1 steps earlier, so a barrier
// lies between.  Those records pass through a ring of kRingD waves of
// kBWords words (H's 5 fields and G's 4, padded to three 16-byte words);
// a slot is overwritten kRingD - kSkew - 1 steps after its read, so
// kRingD >= 2 kSkew + 2 puts a barrier between the read and the write.
constexpr int kSkew = 7, kEvery = kSkew + 1, kRingD = 16, kBWords = 12;
static_assert(kRingD >= 2 * kSkew + 2 && (kRingD & (kRingD - 1)) == 0,
              "a ring slot must outlive its read");
// The position ring: what a row reads at genome position n (the genome's
// code at n - 1, cano3, cano5, dinc3, dinc5 in one word; sig5; sss3), for
// kPosRing positions.  At step s a slab's rows read positions head(s) -
// (nw - 1) kSkew - (R - 1) ... head(s), head(s) = s + const; the slab's
// first warp loads kLoad positions every kLoad steps, kSkew + 1 steps
// ahead of their first read (a barrier lies between), into slots whose
// last read lies a barrier earlier.
constexpr int kPosRing = 512, kLoad = 32;
static_assert(kPosRing >= (kRowsMaxC / 32 - 1) * kSkew + kRowsMaxC - 1 +
                              2 * kEvery + kLoad - 1,
              "a position must outlive its reads");

// the records row i + 1 reads: H (V, D, GA, GB, J), G (V, GA, GB, J)
struct Rec9 {
  float V;
  int D, GA, GB, J;
  float gV;
  int gGA, gGB, gJ;
};

// the row's horizontal carry, its donor list in rank order (entry k holds
// rank k; cK = lane | the donor's dinc5 << 2)
struct CarryC {
  float f1V;
  int f1D, f1GA, f1J;
  float hpV;
  int hpD, hpGA, hpGB, hpJ;
  float cV[NSLOT];
  int cJ[NSLOT], cK[NSLOT];
  int ncand;
};

// the split cluster barrier: a warp's ring and position writes are
// released at the arrive and acquired by the others at the wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ Rec9 init_rec(const Params& p, int s) {
  const int W2 = p.W + 2;
  return Rec9{p.h0v[s],      p.h0i[s],      p.h0i[W2 + s],
              p.h0i[2 * W2 + s], p.h0i[3 * W2 + s], p.g0v[s],
              p.g0i[W2 + s], p.g0i[2 * W2 + s], p.g0i[3 * W2 + s]};
}

__device__ __forceinline__ Rec9 shfl_up9(const Rec9& r) {
  const unsigned all = 0xffffffffu;
  return Rec9{__shfl_up_sync(all, r.V, 1),   __shfl_up_sync(all, r.D, 1),
              __shfl_up_sync(all, r.GA, 1),  __shfl_up_sync(all, r.GB, 1),
              __shfl_up_sync(all, r.J, 1),   __shfl_up_sync(all, r.gV, 1),
              __shfl_up_sync(all, r.gGA, 1), __shfl_up_sync(all, r.gGB, 1),
              __shfl_up_sync(all, r.gJ, 1)};
}

__device__ __forceinline__ Rec9 ring_read(const int* w) {
  const int4 a = *(const int4*)w, b = *(const int4*)(w + 4),
             c = *(const int4*)(w + 8);
  return Rec9{__int_as_float(a.x), a.y, a.z, a.w, b.x,
              __int_as_float(b.y), b.z, b.w, c.x};
}

__device__ __forceinline__ void ring_write(int* w, const Rec9& r) {
  *(int4*)w = make_int4(__float_as_int(r.V), r.D, r.GA, r.GB);
  *(int4*)(w + 4) = make_int4(r.J, __float_as_int(r.gV), r.gGA, r.gGB);
  *(int4*)(w + 8) = make_int4(r.gJ, 0, 0, 0);
}

// Chained clusters: a cluster's first row reads the previous cluster's
// last row through device memory.  That row's records go into a column,
// one entry of kBWords words a wave (every wave, not a ring), and its
// progress counter, the last wave written, is stored with release at gpu
// scope every kEvery steps.  The next cluster's first warp acquires the
// counter at the start of a period, once the column's entries it holds
// run short, until it shows what the warp needs.  Lanes 0 .. kEvery - 1 load
// the next period's entries with ld.global.cg (the L2, never a stale L1
// line), a period ahead of their use, and put them into a stage ring in
// shared memory at the period's start; lane 0 then reads that ring as a
// warp reads the ring of the warp above.
constexpr int kCntStride = 32;  // a counter a 128-byte line
constexpr int kDone = 0x7fffffff;
constexpr long long kStall = 1LL << 35;  // cycles, ~17 s at 2 GHz

__device__ __forceinline__ int ld_acquire(const int* q) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(q) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* q, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(q), "r"(v) : "memory");
}

// Wait until the counter shows ``need``.  A reader whose writer makes no
// progress for kStall cycles traps, so that a cluster the card does not
// run (a card shared with another program) fails the launch instead of
// hanging it.  Out of line: inlined, the spin made the long gene's
// chained sweep ~1.7 % slower (tools/k5_bench.py; PERF.md §6).
__device__ __noinline__ int column_spin(const int* cnt, int need, int avail) {
  int seen = avail;
  long long since = clock64();
  do {
    __nanosleep(64);
    avail = ld_acquire(cnt);
    if (avail != seen) {
      seen = avail;
      since = clock64();
    } else if (clock64() - since > kStall) {
      __trap();
    }
  } while (avail < need);
  return avail;
}

struct Ent {
  int4 a, b, c;
};

__device__ __forceinline__ Ent column_load(const int* col, int w, int T) {
  const int* e = col + (size_t)min(max(w, 0), T) * kBWords;
  return Ent{__ldcg((const int4*)e), __ldcg((const int4*)(e + 4)),
             __ldcg((const int4*)(e + 8))};
}

__device__ __forceinline__ void stage_write(int* w, const Ent& x) {
  *(int4*)w = x.a;
  *(int4*)(w + 4) = x.b;
  *(int4*)(w + 8) = x.c;
}

// The first warp of a cluster after the first, at the start of the period
// whose first wave is t: the entries of waves t - 1 .. t + kEvery - 2 into
// the stage ring, and those of the next period's into ``pre`` (lane l
// holds wave t + kEvery - 1 + l).  The row above's cells end at wave
// ``lastw``; ``avail`` is the counter's last value read.
__device__ __forceinline__ void column_stage(const int* col, const int* cnt,
                                             int* stage, int t, int T,
                                             int lastw, bool first,
                                             int& avail, Ent& pre) {
  const int lane = threadIdx.x & 31;
  if (!first && lane < kEvery)
    stage_write(stage + ((t - 1 + lane) & (kRingD - 1)) * kBWords, pre);
  if (lane == 0) {
    const int need = min(t + 2 * kEvery - 2, lastw);
    if (avail < need) avail = ld_acquire(cnt);
    if (avail < need) avail = column_spin(cnt, need, avail);
  }
  __syncwarp();
  if (lane < kEvery) {
    if (first)
      stage_write(stage + ((t - 1 + lane) & (kRingD - 1)) * kBWords,
                  column_load(col, t - 1 + lane, T));
    pre = column_load(col, t + kEvery - 1 + lane, T);
  }
  __syncwarp();
}

// what the rows read at genome position q, packed into the ring
__device__ __forceinline__ void load_position(const Params& p, int* pr,
                                              int q) {
  const int nc = min(max(q, 0), p.lb);
  const int bn = __ldg(p.b + min(max(q - 1, 0), p.lb - 1));
  const int k = q & (kPosRing - 1);
  pr[k] = bn | (__ldg(p.cano3 + nc) > 0 ? 1 << 8 : 0) |
          (__ldg(p.cano5 + nc) > 0 ? 1 << 9 : 0) |
          __ldg(p.dinc3 + nc) << 10 | __ldg(p.dinc5 + nc) << 14;
  pr[kPosRing + k] = __float_as_int(__ldg(p.sig5 + nc));
  pr[2 * kPosRing + k] = __float_as_int(__ldg(p.sss3 + nc));
}

// one cell of the cluster variant: row i at slot s and genome position n,
// the row above's records d (wave t - 2, slot s) and u (wave t - 1, slot
// s + 1), the position's packed word pw, sig5 and sss3; the same float
// operations as cell(), in its order.  Returns the records row i + 1
// reads.
__device__ __forceinline__ Rec9 cell_c(const Params& p, CarryC& c, int i,
                                       int s, int n, const Rec9& d,
                                       const Rec9& u, int pw, float sj,
                                       float s3, const float* mrow,
                                       const float* p53, const float* pen,
                                       float gop, float gep, Prof& pf) {
  const int W = p.W, W2 = W + 2;
  const int m = i + (p.a_exgl ? 1 : 0);
  const bool valid = n >= max(m + p.lw, 1) && n <= min(m + p.up, p.lb);
  const bool internal = !p.a_exgr || m < p.la;
  const float pua = internal ? gep : 0.f;
  const bool no_diag = m == 0;
  const float bscr = p.la > 0 ? mrow[pw & 0xff] : 0.f;
  pf.mark(kSecMatch);

  // ---- diagonal ----
  float hV = d.V + bscr;
  int hD = is_diag(d.D) ? DIAG : NEWD;
  int hJ = d.J;
  if (no_diag) {
    hV = NEVSEL;
    hD = DEAD;
  }

  // ---- vertical ----
  const float gopv = u.GA >= u.GB ? gop : 0.f;
  const float gnpv = u.gGA >= u.gGB ? gop : 0.f;
  const float vu = u.V + gopv, vg = u.gV + gnpv;
  bool vnew = !is_vert(u.D) && vu > vg;
  float gV = (vnew ? vu : vg) + pua;
  int gJ = vnew ? u.J : u.gJ;
  const int gGB = (vnew ? u.GB : u.gGB) + 1;
  int gD = VERT;
  if (no_diag) {
    gV = NEVSEL;
    vnew = false;
  }

  // ---- horizontal ----
  const float goph = c.hpGA <= c.hpGB ? gop : 0.f;
  const float hh = c.hpV + goph;
  const bool hnew = !is_hori(c.hpD) && hh > c.f1V;
  float nf1V = (hnew ? hh : c.f1V) + gep;
  int nf1J = hnew ? c.hpJ : c.f1J;
  const int nf1GA = (hnew ? c.hpGA : c.f1GA) + 1;
  int nf1D = ((hnew ? c.hpD : c.f1D) & SPIN) + HORI;

  // ---- running max (h -> g strict -> f1 ties) ----
  int w = 0;
  float mxV = hV;
  if (gV > mxV) w = 2;
  mxV = gV > mxV ? gV : mxV;
  if (nf1V >= mxV) w = 1;
  mxV = nf1V > mxV ? nf1V : mxV;
  pf.mark(kSecDVH);

  // ---- 3' acceptor: merge candidates ----
  float lv0 = hV, lv1 = nf1V, lv2 = gV;
  bool jx0 = false, jx1 = false, jx2 = false;
  int jd0 = 0, jd1 = 0, jd2 = 0;
  if (valid && internal && (pw >> 8 & 1)) {
    const int d3 = pw >> 10 & 15;
#pragma unroll
    for (int l = 0; l < NCAND; ++l) {
      if (l < c.ncand) {
        const int cj = c.cJ[l];
        float x = c.cV[l] + pen[min(max(n - cj, 0), p.lb + 1)];
        x = x + p53[16 * (c.cK[l] >> 2) + d3];
        x = x + s3;
        const int lane = c.cK[l] & 3;
        if (lane == 0 && x > lv0) {
          lv0 = x;
          jx0 = true;
          jd0 = cj;
        } else if (lane == 1 && x > lv1) {
          lv1 = x;
          jx1 = true;
          jd1 = cj;
        } else if (lane == 2 && x > lv2) {
          lv2 = x;
          jx2 = true;
          jd2 = cj;
        }
      }
    }
  }
  hV = lv0;
  nf1V = lv1;
  gV = lv2;
  if (jx0) {
    hD |= SPJCI;
    hJ = n;
  }
  if (jx1) {
    nf1D |= SPJCI;
    nf1J = n;
  }
  if (jx2) {
    gD |= SPJCI;
    gJ = n;
  }
  // merged lanes contest the max strictly, in lane order
  mxV = w == 0 ? lv0 : (w == 1 ? lv1 : lv2);
  if (jx0 && lv0 > mxV) {
    w = 0;
    mxV = lv0;
  }
  if (jx1 && lv1 > mxV) {
    w = 1;
    mxV = lv1;
  }
  if (jx2 && lv2 > mxV) {
    w = 2;
    mxV = lv2;
  }

  // ---- the cell record (h <- mx) ----
  const float cV = w == 0 ? hV : (w == 1 ? nf1V : gV);
  const int cD = w == 0 ? hD : (w == 1 ? nf1D : gD);
  const int cGA = w == 1 ? nf1GA : 0;
  const int cGB = w == 2 ? gGB : 0;
  const int cJ = w == 0 ? hJ : (w == 1 ? nf1J : gJ);
  pf.mark(kSecAcc);

  // ---- 5' donor: push candidates, the list kept in rank order ----
  if (valid && internal && (pw >> 9 & 1)) {
    const int hd = dir2nod(cD);
    const int d5 = pw >> 14 & 15;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int fD = k == 0 ? cD : (k == 1 ? nf1D : gD);
      const float fV = k == 0 ? cV : (k == 1 ? nf1V : gV);
      bool ok = (k != 0 || hd == 0) && fD != 0 && (fD & SPIN) == 0;
      const bool thr_on = k != hd && hd >= 0 && k != 0;
      const float y =
          mxV + ((hd == 0 || ((k - hd) % 2) != 0) ? (k == 2 ? gop : 0.f)
                                                   : 0.f);
      if (thr_on) ok = ok && fV > y;
      if (!ok) continue;
      const float x = fV + sj;
      // insertion sort (fwd2s.h:362 semantics): the spare entry at rank
      // l_start bubbles up to the insertion rank
      const int ncand_new = min(c.ncand + 1, NCAND);
      const int l_start = c.ncand < NCAND ? c.ncand + 1 : NCAND;
      int pos = 0;
      bool broken = false;
#pragma unroll
      for (int l = NCAND - 1; l >= 0; --l) {
        const bool active = l < l_start && !broken;
        const bool gt = x > c.cV[l];
        if (active && gt) {
          const float tv = c.cV[l];
          c.cV[l] = c.cV[l + 1];
          c.cV[l + 1] = tv;
          const int tj = c.cJ[l];
          c.cJ[l] = c.cJ[l + 1];
          c.cJ[l + 1] = tj;
          const int tk = c.cK[l];
          c.cK[l] = c.cK[l + 1];
          c.cK[l + 1] = tk;
        }
        if (active && !gt) {
          pos = l + 1;
          broken = true;
        }
      }
      const bool accept = pos < INTR;
      if (accept && pos == 0) {
        c.cV[0] = x;
        c.cJ[0] = n;
        c.cK[0] = k | d5 << 2;
      } else if (accept) {
        c.cV[1] = x;
        c.cJ[1] = n;
        c.cK[1] = k | d5 << 2;
      }
      c.ncand = accept ? ncand_new : ncand_new - 1;
    }
  }
  pf.mark(kSecDon);

  const size_t cellx = (size_t)i * W + (s - 1);
  const int e = w | (vnew ? EV_VNEW : 0) | (hnew ? EV_HNEW : 0) |
                (jx0 ? EV_JXH : 0) | (jx1 ? EV_JXF : 0) | (jx2 ? EV_JXG : 0);
  p.ev[cellx] = valid ? e : -1;
  p.jdon[3 * cellx] = jd0;
  p.jdon[3 * cellx + 1] = jd1;
  p.jdon[3 * cellx + 2] = jd2;
  pf.mark(kSecPlanes);

  // retain old values on invalid slots
  const Rec9 o{valid ? cV : d.V,    valid ? cD : d.D,   valid ? cGA : d.GA,
               valid ? cGB : d.GB,  valid ? cJ : d.J,   valid ? gV : d.gV,
               valid ? 0 : d.gGA,   valid ? gGB : d.gGB, valid ? gJ : d.gJ};
  c.hpV = o.V;
  c.hpD = o.D;
  c.hpGA = o.GA;
  c.hpGB = o.GB;
  c.hpJ = o.J;
  if (valid) {
    c.f1V = nf1V;
    c.f1D = nf1D;
    c.f1GA = nf1GA;
    c.f1J = nf1J;
  }
  if (i == p.rows - 1) {
    p.HV[s] = o.V;
    p.Hi[s] = o.D;
    p.Hi[W2 + s] = o.GA;
    p.Hi[2 * W2 + s] = o.GB;
    p.Hi[3 * W2 + s] = o.J;
  }
  return o;
}

// The cluster variant: one row a thread, a slab of consecutive rows a
// CTA (blockDim.x, whole warps), p.ctas CTAs a cluster; chained, the
// clusters hold consecutive slabs of p.ctas * blockDim.x rows, cluster
// p.c0 + blockIdx.x / p.ctas of this launch.  Each cluster runs the
// schedule of one cluster from the wave its first row starts at, so the
// warps' skew carries on from cluster to cluster.  Shared memory: the
// warps' boundary rings (and, chained, the stage ring of the column),
// the position ring, the matrix, pair53 and, if pen_smem, the penalty
// table by length.  kChain: the chained variant (several clusters);
// without it the kernel is one cluster's, with no column code.
template <bool kChain>
__global__ void __launch_bounds__(kRowsMaxC, 1)
    spliced_s_wave_cluster(Params p) {
  extern __shared__ __align__(16) int smc[];
  const int R = blockDim.x, nw = R >> 5;
  const int rank = (int)cg::this_cluster().block_rank();
  const int lane = threadIdx.x & 31, wl = threadIdx.x >> 5;
  const int kc = kChain ? p.c0 + (int)blockIdx.x / p.ctas : 0;
  const int i0 = kc * p.ctas * R;
  const int i = i0 + rank * R + threadIdx.x;
  const int g = (rank * R + threadIdx.x) >> 5;
  const int RT = p.rows, W = p.W, K = p.K;
  int* const br = smc;
  int* const pr = br + (nw + (kChain ? 1 : 0)) * kRingD * kBWords;
  float* const mtx = (float*)(pr + 3 * kPosRing);
  float* const p53 = mtx + K * K;
  float* const pen_s = p53 + 256;
  const float* const pen = p.pen_smem ? pen_s : p.pen;
  for (int k = threadIdx.x; k < K * K; k += R) mtx[k] = p.mtx[k];
  for (int k = threadIdx.x; k < 256; k += R) p53[k] = p.pair53[k];
  if (p.pen_smem)
    for (int k = threadIdx.x; k < p.lb + 2; k += R) pen_s[k] = p.pen[k];
  // the ring this warp's last row writes, and the one its first row
  // reads: the previous warp's, or the previous CTA's last warp's
  int* const own = br + wl * kRingD * kBWords;
  const int* above = nullptr;
  if (wl > 0)
    above = br + (wl - 1) * kRingD * kBWords;
  else if (rank > 0)
    above = cg::this_cluster().map_shared_rank(br, rank - 1) +
            (nw - 1) * kRingD * kBWords;
  else if (kChain && kc > 0)
    above = br + nw * kRingD * kBWords;
  const int T = 2 * (RT - 1) + W;
  // chained: the column this cluster's first warp reads, and the one its
  // last warp's last row writes
  const size_t colw = (size_t)(T + 1) * kBWords;
  int* const col = p.scratch + (size_t)(p.nclus - 1) * kCntStride;
  const bool reader = kChain && kc > 0 && rank == 0 && wl == 0;
  const bool writer =
      kChain && kc < p.nclus - 1 && rank == p.ctas - 1 && wl == nw - 1;
  const int* const col_in = reader ? col + (kc - 1) * colw : nullptr;
  const int* const cnt_in = reader ? p.scratch + (kc - 1) * kCntStride
                                   : nullptr;
  int* const col_out = writer ? col + kc * colw : nullptr;
  int* const cnt_out = writer ? p.scratch + kc * kCntStride : nullptr;
  // the cluster's step s takes wave s + tbase in its first warp: its first
  // row's first cell at s = 3 (s = 1 in the first cluster), two steps
  // after the first read of the column
  const int tbase = kc > 0 ? 2 * i0 - 2 : 0;
  const int lastw = 2 * i0 + W - 2;
  int avail = 0;
  Ent pre{};
  // row i at wave t reads genome position n = t - i + lw - 1 + m_start;
  // the slab's highest at step s is head(s) = s + hoff (its first row)
  const int m0 = p.a_exgl ? 1 : 0;
  const int hoff = tbase + p.lw - 1 + m0 - i0 - rank * nw * kSkew - rank * R;
  for (int q = 1 + hoff + kEvery - (kPosRing - kLoad) + (int)threadIdx.x;
       q < 1 + hoff + kEvery; q += R)
    load_position(p, pr, q);

  const int t_end = min(T, 2 * (min(i0 + p.ctas * R, RT) - 1) + W);
  const int s_last = t_end - tbase + (p.ctas * nw - 1) * kSkew;
  const float gop = p.fprm[0], gep = p.fprm[1];
  const int m = i + m0;
  const float* const mrow =
      mtx + (p.la > 0 && i < RT ? __ldg(p.a + max(m - 1, 0)) : 0) * K;
  // the init records at slot W + 1, and row 0's at slots s and s + 1
  const Rec9 initW1 = init_rec(p, W + 1);
  Rec9 i0d = initW1, i0u = initW1;
  if (i == 0) {
    i0d = init_rec(p, 1);
    i0u = init_rec(p, min(2, W + 1));
  }
  CarryC c;
  c.f1V = NEVSEL;
  c.f1D = c.f1GA = c.f1J = 0;
  c.hpV = p.h0v[0];
  c.hpD = p.h0i[0];
  c.hpGA = p.h0i[W + 2];
  c.hpGB = p.h0i[2 * (W + 2)];
  c.hpJ = p.h0i[3 * (W + 2)];
  const int k0 = __ldg(p.dinc5) << 2;
#pragma unroll
  for (int j = 0; j < NSLOT; ++j) {
    c.cV[j] = NEVSEL;
    c.cJ[j] = 0;
    c.cK[j] = k0;
  }
  c.ncand = 0;
  // this row's record of the last wave it took, and the row above's of
  // the last two
  Rec9 mine = initW1, ureg = initW1;
  Prof pf;
  cluster_arrive();
  cluster_wait();

  for (int s = 1; s <= s_last; ++s) {
    const int ph = (s - 1) % kEvery;
    const int t = s + tbase - g * kSkew;
    __syncwarp();
    if (ph == 0 && s > 1) cluster_wait();
    pf.mark(kSecWait);
    if (wl == 0 && (s - 1) % kLoad == 0)
      load_position(p, pr, s + hoff + kEvery + lane);
    if (reader && ph == 0)
      column_stage(col_in, cnt_in, br + nw * kRingD * kBWords, t, T, lastw,
                   s == 1, avail, pre);
    if (t >= 1 && t <= T) {
      // the row above's records: wave t - 2 kept from the last step,
      // wave t - 1 from lane l - 1 or the ring above
      const Rec9 dreg = ureg;
      ureg = shfl_up9(mine);
      if (lane == 0 && above != nullptr)
        ureg = ring_read(above + ((t - 1) & (kRingD - 1)) * kBWords);
      const int sl = t - 2 * i;
      if (i < RT && sl >= 1 && sl <= W) {
        const int n = t - i + p.lw - 1 + m0;
        const int q = n & (kPosRing - 1);
        const int pw = pr[q];
        const float sj = __int_as_float(pr[kPosRing + q]);
        const float s3 = __int_as_float(pr[2 * kPosRing + q]);
        const Rec9 d = i == 0 ? i0d : dreg;
        const Rec9 u = i == 0 ? i0u : (sl == W ? initW1 : ureg);
        pf.mark(kSecRead);
        mine = cell_c(p, c, i, sl, n, d, u, pw, sj, s3, mrow, p53, pen, gop,
                      gep, pf);
        if (lane == 31) {
          ring_write(own + (t & (kRingD - 1)) * kBWords, mine);
          if (writer) ring_write(col_out + (size_t)t * kBWords, mine);
        }
        pf.mark(kSecRing);
      }
      pf.mark(kSecIdle);
      if (i == 0) {
        i0d = i0u;
        i0u = init_rec(p, min(t + 2, W + 1));
      }
    }
    if (ph == kEvery - 1) {
      cluster_arrive();
      if (writer && lane == 31 && t >= 1) st_release(cnt_out, t);
    }
  }
  if (writer && lane == 31) st_release(cnt_out, kDone);
  // no CTA leaves while the next one may still read its ring
  if ((s_last - 1) % kEvery != kEvery - 1) cluster_arrive();
  cluster_wait();
  pf.flush(s_last);
}

}  // namespace

#ifdef K5_PROFILE
// the profile's sums (kSections, then the steps they cover), cleared
// after the read if ``clear``
extern "C" int k5_profile_read(void* out, int clear) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k5_prof, sizeof(k5_prof));
  if (e == cudaSuccess && clear) {
    unsigned long long z[kSections + 1] = {};
    e = cudaMemcpyToSymbol(k5_prof, z, sizeof(z));
  }
  return (int)e;
}
#endif

namespace {

size_t cluster_smem(int threads, int K, int lb, int pen_smem, int chain) {
  return ((size_t)(threads / 32 + (chain ? 1 : 0)) * kRingD * kBWords +
          3 * kPosRing + (size_t)K * K + 256 +
          (pen_smem ? (size_t)lb + 2 : 0)) *
         sizeof(int);
}

// a launch of ``clusters`` clusters of ``ctas`` CTAs
cudaLaunchConfig_t cluster_config(int clusters, int ctas, int threads,
                                  int smem, cudaLaunchAttribute* attr,
                                  cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the cluster variant's kernel, or the chained variant's
const void* cluster_kernel(int chain) {
  return chain ? (const void*)spliced_s_wave_cluster<true>
               : (const void*)spliced_s_wave_cluster<false>;
}

cudaError_t cluster_attributes(int chain, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      cluster_kernel(chain), cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(cluster_kernel(chain),
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

}  // namespace

// How many clusters of ``ctas`` CTAs of ``threads`` threads and ``smem``
// bytes of the cluster variant's kernel (the chained variant's if
// ``chain``) the card can hold at once (cudaOccupancyMaxActiveClusters)
// into out[0]: 0 where it cannot hold one.
extern "C" int spliced_s_wave_max_clusters(int ctas, int threads, int smem,
                                           int chain, void* out) {
  if (ctas < 1 || ctas > kClusterMax || threads < 32 ||
      threads > kRowsMaxC || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cluster_attributes(chain, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(1, ctas, threads, smem, &attr, nullptr);
  return (int)cudaOccupancyMaxActiveClusters((int*)out, cluster_kernel(chain),
                                             &cfg);
}

// words of global scratch a row: its rings unless they sit in shared
// memory, and its carry when a thread takes several rows
extern "C" int spliced_s_wave_scratch_words(int ring_smem, int multi) {
  return (ring_smem ? 0 : kRingWords) + (multi ? kStateWords : 0);
}

// words of global scratch of ``clusters`` chained clusters over ``rows``
// rows and ``W`` slots: a counter (a 128-byte line) and a column of an
// entry a wave for each boundary; -1 past 2**31 words.  The counters must
// be zero at the launch.
extern "C" int spliced_s_wave_chain_words(int clusters, int rows, int W) {
  if (clusters <= 1) return 0;
  const long long n = (long long)(clusters - 1) *
                      (kCntStride + (2LL * (rows - 1) + W + 1) * kBWords);
  return n < (1LL << 31) ? (int)n : -1;
}

// The plan of ops/spliced_s.py::sweep_s_plan.  ``cluster``: ``clusters``
// clusters of ``ctas`` CTAs of ``threads`` rows, run ``per_pass``
// clusters a launch (each pass's clusters at once on the card: at most
// what cudaOccupancyMaxActiveClusters finds room for, or the launch is
// refused), ``smem`` bytes of shared memory a CTA (the rings, the stage
// ring if chained, the position ring, the matrix, pair53 and, if
// ``pen_smem``, the penalty table); ``scratch`` holds
// spliced_s_wave_chain_words words, counters zero.  Else the global variant: one block of ``threads`` threads of
// ``rpt`` rows each, ``smem`` bytes of shared memory (the matrix and
// pair53, then the rings if ``ring_smem`` and the penalty table if
// ``pen_smem``).  A launch either variant refuses returns its error;
// neither stands in for the other.
extern "C" int spliced_s_wave_launch(
    const void* a, const void* b, const void* mtx, const void* cano3,
    const void* cano5, const void* sig5, const void* dinc5,
    const void* dinc3, const void* sss3, const void* pair53, const void* pen,
    const void* h0v, const void* h0i, const void* g0v, const void* g0i,
    const void* fprm, void* scratch, void* ev, void* jdon, void* HV,
    void* Hi, int la, int lb, int lw, int up, int a_exgl, int a_exgr, int K,
    int cluster, int ctas, int threads, int rpt, int ring_smem, int pen_smem,
    int smem, int clusters, int per_pass, void* stream) {
  Params p;
  p.a = (const int*)a;
  p.b = (const int*)b;
  p.mtx = (const float*)mtx;
  p.cano3 = (const int*)cano3;
  p.cano5 = (const int*)cano5;
  p.sig5 = (const float*)sig5;
  p.dinc5 = (const int*)dinc5;
  p.dinc3 = (const int*)dinc3;
  p.sss3 = (const float*)sss3;
  p.pair53 = (const float*)pair53;
  p.pen = (const float*)pen;
  p.h0v = (const float*)h0v;
  p.h0i = (const int*)h0i;
  p.g0v = (const float*)g0v;
  p.g0i = (const int*)g0i;
  p.fprm = (const float*)fprm;
  p.scratch = (int*)scratch;
  p.ev = (int*)ev;
  p.jdon = (int*)jdon;
  p.HV = (float*)HV;
  p.Hi = (int*)Hi;
  p.la = la;
  p.lb = lb;
  p.lw = lw;
  p.up = up;
  p.a_exgl = a_exgl;
  p.a_exgr = a_exgr;
  p.K = K;
  p.rows = la + 1 - (a_exgl ? 1 : 0);
  p.W = up - lw + 1;
  p.ring_smem = ring_smem;
  p.pen_smem = pen_smem;
  cudaStream_t s = (cudaStream_t)stream;
  p.ctas = ctas;
  p.nclus = clusters;
  if (cluster) {
    const size_t rows_c = (size_t)ctas * threads;
    if (p.rows < 1 || p.W < 1 || lb < 1 || K > 256 ||
        ring_smem || ctas < 1 || ctas > kClusterMax || threads < 32 ||
        threads > kRowsMaxC || threads % 32 != 0 || clusters < 1 ||
        per_pass < 1 || rows_c * clusters < (size_t)p.rows ||
        rows_c * (clusters - 1) >= (size_t)p.rows ||
        cluster_smem(threads, K, lb, pen_smem, clusters > 1) !=
            (size_t)smem ||
        smem > kSmemMax || (clusters > 1 && scratch == nullptr))
      return (int)cudaErrorInvalidValue;
    const int chain = clusters > 1;
    cudaError_t err = cluster_attributes(chain, smem);
    if (err != cudaSuccess) return (int)err;
    // a cluster waits on the one before it: every cluster of a launch must
    // be on the card at once
    const int most = per_pass < clusters ? per_pass : clusters;
    if (most > 1) {
      int held = 0;
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg =
          cluster_config(1, ctas, threads, smem, &attr, s);
      err = cudaOccupancyMaxActiveClusters(&held, cluster_kernel(chain),
                                           &cfg);
      if (err != cudaSuccess) return (int)err;
      if (held < most) return (int)cudaErrorCooperativeLaunchTooLarge;
    }
    // the passes: a pass's first cluster reads a column the last pass
    // finished
    for (int c0 = 0; c0 < clusters; c0 += per_pass) {
      p.c0 = c0;
      const int n = clusters - c0 < per_pass ? clusters - c0 : per_pass;
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg =
          cluster_config(n, ctas, threads, smem, &attr, s);
      err = chain ? cudaLaunchKernelEx(&cfg, spliced_s_wave_cluster<true>, p)
                  : cudaLaunchKernelEx(&cfg, spliced_s_wave_cluster<false>, p);
      if (err != cudaSuccess) return (int)err;
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  p.c0 = 0;
  const size_t need =
      ((size_t)K * K + 256 + (ring_smem ? (size_t)kRingWords * p.rows : 0) +
       (pen_smem ? (size_t)lb + 2 : 0)) *
      sizeof(float);
  if (p.rows < 1 || p.W < 1 || lb < 1 || threads < 1 ||
      threads > kThreadsMax || rpt < 1 || (size_t)threads * rpt < (size_t)p.rows ||
      (rpt == 1) != (threads >= p.rows) || need != (size_t)smem ||
      smem > kSmemMax || ctas != 1 || clusters != 1 || per_pass != 1)
    return (int)cudaErrorInvalidValue;
  if (rpt == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        spliced_s_wave_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    spliced_s_wave_kernel<true><<<1, threads, smem, s>>>(p, rpt);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        spliced_s_wave_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    spliced_s_wave_kernel<false><<<1, threads, smem, s>>>(p, rpt);
  }
  return (int)cudaGetLastError();
}

// registers a thread and local (spilled) bytes of a kernel: the global
// variant's one-row (variant 0) or several-rows (1) kernel, or the
// cluster variant's (2) or the chained variant's (3)
extern "C" int spliced_s_wave_attrs(int variant, void* out) {
  cudaFuncAttributes at;
  const cudaError_t err =
      variant >= 2   ? cudaFuncGetAttributes(&at, cluster_kernel(variant == 3))
      : variant == 1 ? cudaFuncGetAttributes(&at, spliced_s_wave_kernel<false>)
                     : cudaFuncGetAttributes(&at, spliced_s_wave_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  int* o = (int*)out;
  o[0] = at.numRegs;
  o[1] = (int)at.localSizeBytes;
  return 0;
}
