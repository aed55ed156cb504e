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
// What bounds it on the card: the serial anti-diagonal chain.  A pair
// takes nsteps dependent steps (La + Lb + 1, bucketed) with one
// __syncthreads each.  In a step each live slot sums an*bn member pairs
// six times (eight with ls3) for the exact gap-open counts (crg), and
// reads 10 gap-run lanes of its own and its two neighbours' members:
// about 10 * (an + bn) * 4 * 3 bytes per cell, kept in L1/L2.
//
// What the design does about it: one thread block per pair, so a batch
// of pairs runs side by side on the SMs.  At step d only slots of d's
// parity change, and they read only their own slot and the two
// neighbours of the other parity, so the lane values (H, G, F, G2, F2,
// Hdir) are updated in place in shared memory and one barrier a step
// suffices; thread t takes the live slot 2t + parity, so no thread
// idles on the wrong parity.  The per-member gap-run lengths (10 lanes x
// members x nslot) live in a global scratch laid out member-major with
// the slot fastest, so neighbouring threads read neighbouring words.
// The profile score of a cell, sum_c CA[m-1,c] * CB[n-1,c], is taken
// in the cell from the channel stacks; the score image is never stored.
//
// Sums of products (the crg sums and the profile score) run in one fixed
// order, each term added like a fused multiply-add: the product in f64
// (exact for f32 factors) is added to the f32 sum in f64 and the result
// rounded to f32.  The gap costs added to lane values are fused the same
// way where the JAX reference's are on the CPU; the plain version
// computes every one of these identically.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNevsel = -1.0e30f;
constexpr int8_t D_DIAG = 1, D_VERT = 2, D_HORI = 3;
constexpr int8_t L_DIAG = 0, L_VERT = 1, L_HORI = 2, L_VERT2 = 3,
                 L_HORI2 = 4;
// gap-run lanes in the scratch
constexpr int GH = 0, GG = 1, GF = 2, GG2 = 3, GF2 = 4;
constexpr int kMaxThreads = 512;

struct Args {
  const float *CA, *CB, *ea0, *eb0;
  const float *na_a, *gda, *pga, *na_b, *gdb, *pgb;
  const float *cfa, *efa, *cfb, *efb, *wa, *wb;
  const int32_t* iprm;   // (B, 5): la, lb, lw, up, k1
  const float* fprm;     // (B, 4): u, gop_scale, v2divv1, u2divu1
  float* score;
  int8_t *dirs, *opens;
  int32_t* gl;           // (B, 5 * (an + bn), nslot)
  int C, an, bn, la_max, lb_max, nslot, nsteps;
};

// a * b + c rounded once to f32: the f64 product of f32 factors is exact
// and the f64 sum is rounded to f32 (ops/group.py::_fma)
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

// One pair's view of the gap-run scratch and column arrays.
struct Pair {
  const Args& a;
  int32_t* gl;
  const float *na_a, *gda, *pga, *na_b, *gdb, *pgb, *wa, *wb;

  __device__ int32_t* gla(int lane, int i, int k) const {
    return gl + ((size_t)(lane * a.an + i)) * a.nslot + k;
  }
  __device__ int32_t* glb(int lane, int j, int k) const {
    return gl + ((size_t)(5 * a.an + lane * a.bn + j)) * a.nslot + k;
  }
  // gap-run length of lane at slot k (0 outside the band array)
  __device__ int32_t ga(int lane, int i, int k) const {
    return (k >= 0 && k < a.nslot) ? *gla(lane, i, k) : 0;
  }
  __device__ int32_t gb(int lane, int j, int k) const {
    return (k >= 0 && k < a.nslot) ? *glb(lane, j, k) : 0;
  }

  // sum_i sum_j xa_i * [cmp(i, j)] * yb_j, i outer, j inner, where
  // xa_i = wa[i] * XA[mc, i] and yb_j = wb[j] * YB[nc, j]; cmp is
  // gla >= glb (le=false) or glb >= gla (le=true).
  __device__ float pair_sum(const float* XA, const float* YB, int mc, int nc,
                            int lane, int k, bool le) const {
    float acc = 0.0f;
    for (int i = 0; i < a.an; ++i) {
      const float x = wa[i] * XA[(size_t)mc * a.an + i];
      const int32_t gi = ga(lane, i, k);
      for (int j = 0; j < a.bn; ++j) {
        const int32_t gj = gb(lane, j, k);
        const bool c = le ? (gj >= gi) : (gi >= gj);
        const float y = wb[j] * YB[(size_t)nc * a.bn + j];
        acc = (float)((double)acc + (c ? (double)x * (double)y : 0.0));
      }
    }
    return acc;
  }

  // weighted new-gap count (group.py _wavefront_core.crg) of the state
  // in `lane` at slot k for the cell (mc, nc), before the gop_scale factor
  __device__ float crg(int lane, int k, int d3, int mc, int nc) const {
    if (d3 == 0)
      return pair_sum(na_a, gdb, mc, nc, lane, k, false) +
             pair_sum(gda, na_b, mc, nc, lane, k, true);
    if (d3 > 0) return pair_sum(na_a, pgb, mc, nc, lane, k, false);
    return pair_sum(pga, na_b, mc, nc, lane, k, true);
  }
};

template <bool LS3>
__global__ void __launch_bounds__(kMaxThreads)
group_wavefront_kernel(Args args) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int nslot = args.nslot, an = args.an, bn = args.bn;
  const int la_max = args.la_max, lb_max = args.lb_max, C = args.C;
  const int la = args.iprm[5 * b + 0], lb = args.iprm[5 * b + 1];
  const int lw = args.iprm[5 * b + 2], up = args.iprm[5 * b + 3];
  const int k1 = args.iprm[5 * b + 4];
  const float u = args.fprm[4 * b + 0], gop_scale = args.fprm[4 * b + 1];
  const float v2divv1 = args.fprm[4 * b + 2], u2divu1 = args.fprm[4 * b + 3];
  const float neg_u = -u;

  const Pair P{args, args.gl + (size_t)b * 5 * (an + bn) * nslot,
               args.na_a + (size_t)b * (la_max + 1) * an,
               args.gda + (size_t)b * (la_max + 1) * an,
               args.pga + (size_t)b * (la_max + 1) * an,
               args.na_b + (size_t)b * (lb_max + 1) * bn,
               args.gdb + (size_t)b * (lb_max + 1) * bn,
               args.pgb + (size_t)b * (lb_max + 1) * bn,
               args.wa + (size_t)b * an, args.wb + (size_t)b * bn};
  const float* CA = args.CA + (size_t)b * la_max * C;
  const float* CB = args.CB + (size_t)b * lb_max * C;
  const float* ea0 = args.ea0 + (size_t)b * la_max;
  const float* eb0 = args.eb0 + (size_t)b * lb_max;
  const float* cfa = args.cfa + (size_t)b * (la_max + 1);
  const float* efa = args.efa + (size_t)b * (la_max + 1);
  const float* cfb = args.cfb + (size_t)b * (lb_max + 1);
  const float* efb = args.efb + (size_t)b * (lb_max + 1);
  int8_t* dirs = args.dirs + (size_t)b * args.nsteps * nslot;
  int8_t* opens = args.opens + (size_t)b * args.nsteps * nslot;

  float* Hval = smem;
  float* Gval = Hval + nslot;
  float* Fval = Gval + nslot;
  float* G2val = Fval + nslot;
  float* F2val = G2val + nslot;
  int8_t* Hdir = (int8_t*)(F2val + nslot);

  for (int k = threadIdx.x; k < nslot; k += blockDim.x) {
    const bool corner = lw - 1 + k == 0;
    Hval[k] = corner ? 0.0f : kNevsel;
    Hdir[k] = corner ? D_DIAG : 0;
    Gval[k] = Fval[k] = G2val[k] = F2val[k] = kNevsel;
  }
  for (size_t i = threadIdx.x; i < (size_t)5 * (an + bn) * nslot;
       i += blockDim.x)
    P.gl[i] = 0;
  __syncthreads();

  const int npairs = (nslot + 1) / 2;
  for (int d = 0; d < args.nsteps; ++d) {
    int8_t* drow = dirs + (size_t)d * nslot;
    int8_t* orow = opens + (size_t)d * nslot;
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
      float s_cell = 0.0f;
      for (int c = 0; c < C; ++c)
        s_cell = fma_f64(CA[(size_t)mi * C + c], CB[(size_t)ni * C + c], s_cell);
      const float b0_cell = (m >= 1 && n >= 1) ? ea0[mi] * eb0[ni] : 0.0f;
      const float pua = cfa[mc] * efb[nc] * neg_u;
      const float pub = cfb[nc] * efa[mc] * neg_u;

      const int klo = k - 1, khi = k + 1;
      const float Hval_lo = k > 0 ? Hval[klo] : kNevsel;
      const int8_t Hdir_lo = k > 0 ? Hdir[klo] : 0;
      const float Fval_lo = k > 0 ? Fval[klo] : kNevsel;
      const float Hval_hi = khi < nslot ? Hval[khi] : kNevsel;
      const int8_t Hdir_hi = khi < nslot ? Hdir[khi] : 0;
      const float Gval_hi = khi < nslot ? Gval[khi] : kNevsel;

      // x + crg * gop_scale and the ls3 rate terms are fused
      // multiply-adds where the plain version's are (ops/group.py)
      // diagonal candidate (same slot, step d-2)
      const float d_val =
          fma_f64(P.crg(GH, k, 0, mc, nc), gop_scale, Hval[k] + s_cell);

      // vertical lane
      const float rgop_v = P.crg(GH, khi, 1, mc, nc);
      const float ext_gv = fma_f64(P.crg(GG, khi, 1, mc, nc), gop_scale, Gval_hi);
      const float gop_v = rgop_v * gop_scale;
      const float open_gv = LS3 ? Hval_hi + gop_v : fma_f64(rgop_v, gop_scale, Hval_hi);
      const bool open_v = (Hdir_hi != D_VERT) && (open_gv > ext_gv);
      float gv = (open_v ? open_gv : ext_gv) + pua;
      const bool vert_ok = m >= 2;
      if (!vert_ok) gv = kNevsel;

      // horizontal lane
      const float rgop_h = P.crg(GH, klo, -1, mc, nc);
      const float ext_fv = fma_f64(P.crg(GF, klo, -1, mc, nc), gop_scale, Fval_lo);
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
        const float ext_g2v = fma_f64(
            v2divv1, P.crg(GG2, khi, 1, mc, nc) * gop_scale, G2val_hi);
        open_v2 = (Hdir_hi != D_VERT) && (open_g2v > ext_g2v);
        g2v = fma_f64(u2divu1, pua, open_v2 ? open_g2v : ext_g2v);
        if (!vert_ok) g2v = kNevsel;
        const float open_f2v = fma_f64(v2divv1, gop_h, Hval_lo);
        const float ext_f2v = fma_f64(
            v2divv1, P.crg(GF2, klo, -1, mc, nc) * gop_scale, F2val_lo);
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

      // per-member gap-run lengths; slot k's lanes are read before they
      // are written, and no other slot reads them in this step
      for (int i = 0; i < an; ++i) {
        const bool a_gap = P.na_a[(size_t)mc * an + i] <= 0.0f;
        const int32_t h_old = *P.gla(GH, i, k);
        const int32_t h_hi = P.ga(GH, i, khi), h_lo = P.ga(GH, i, klo);
        const int32_t g_gla = a_gap ? (open_v ? h_hi : P.ga(GG, i, khi)) + 1 : 0;
        const int32_t f_gla = (open_h ? h_lo : P.ga(GF, i, klo)) + 1;
        int32_t g2_gla = 0, f2_gla = 0;
        if (LS3) {
          g2_gla = a_gap ? (open_v2 ? h_hi : P.ga(GG2, i, khi)) + 1 : 0;
          f2_gla = (open_h2 ? h_lo : P.ga(GF2, i, klo)) + 1;
        }
        int32_t mx = mx_lane == L_VERT ? g_gla : f_gla;
        if (LS3)
          mx = mx_lane == L_VERT ? g_gla : mx_lane == L_VERT2 ? g2_gla
             : mx_lane == L_HORI ? f_gla : f2_gla;
        int32_t h_new = nondiag ? mx : (a_gap ? h_old + 1 : 0);
        if (is_top) h_new = h_lo + 1;
        else if (is_left) h_new = a_gap ? h_hi + 1 : 0;
        *P.gla(GH, i, k) = h_new;
        *P.gla(GG, i, k) = g_gla;
        *P.gla(GF, i, k) = f_gla;
        if (LS3) {
          *P.gla(GG2, i, k) = g2_gla;
          *P.gla(GF2, i, k) = f2_gla;
        }
      }
      for (int j = 0; j < bn; ++j) {
        const bool b_gap = P.na_b[(size_t)nc * bn + j] <= 0.0f;
        const int32_t h_old = *P.glb(GH, j, k);
        const int32_t h_hi = P.gb(GH, j, khi), h_lo = P.gb(GH, j, klo);
        const int32_t g_glb = (open_v ? h_hi : P.gb(GG, j, khi)) + 1;
        const int32_t f_glb = b_gap ? (open_h ? h_lo : P.gb(GF, j, klo)) + 1 : 0;
        int32_t g2_glb = 0, f2_glb = 0;
        if (LS3) {
          g2_glb = (open_v2 ? h_hi : P.gb(GG2, j, khi)) + 1;
          f2_glb = b_gap ? (open_h2 ? h_lo : P.gb(GF2, j, klo)) + 1 : 0;
        }
        int32_t mx = mx_lane == L_VERT ? g_glb : f_glb;
        if (LS3)
          mx = mx_lane == L_VERT ? g_glb : mx_lane == L_VERT2 ? g2_glb
             : mx_lane == L_HORI ? f_glb : f2_glb;
        int32_t h_new = nondiag ? mx : (b_gap ? h_old + 1 : 0);
        if (is_top) h_new = b_gap ? h_lo + 1 : 0;
        else if (is_left) h_new = h_hi + 1;
        *P.glb(GH, j, k) = h_new;
        *P.glb(GG, j, k) = g_glb;
        *P.glb(GF, j, k) = f_glb;
        if (LS3) {
          *P.glb(GG2, j, k) = g2_glb;
          *P.glb(GF2, j, k) = f2_glb;
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

  if (threadIdx.x == 0) {
    const int k_end = (lb - la) - (lw - 1);
    args.score[b] = (k_end >= 0 && k_end < nslot) ? Hval[k_end] : kNevsel;
  }
}

}  // namespace

extern "C" int group_wavefront_launch(
    const void* CA, const void* CB, const void* ea0, const void* eb0,
    const void* na_a, const void* gda, const void* pga, const void* na_b,
    const void* gdb, const void* pgb, const void* cfa, const void* efa,
    const void* cfb, const void* efb, const void* wa, const void* wb,
    const void* iprm, const void* fprm, void* score, void* dirs, void* opens,
    void* gl, int B, int C, int an, int bn, int la_max, int lb_max,
    int nslot, int nsteps, int ls3, void* stream) {
  Args args{(const float*)CA, (const float*)CB, (const float*)ea0,
            (const float*)eb0, (const float*)na_a, (const float*)gda,
            (const float*)pga, (const float*)na_b, (const float*)gdb,
            (const float*)pgb, (const float*)cfa, (const float*)efa,
            (const float*)cfb, (const float*)efb, (const float*)wa,
            (const float*)wb, (const int32_t*)iprm, (const float*)fprm,
            (float*)score, (int8_t*)dirs, (int8_t*)opens, (int32_t*)gl,
            C, an, bn, la_max, lb_max, nslot, nsteps};
  const size_t smem = (size_t)nslot * (5 * sizeof(float) + 1);
  int threads = ((nslot + 1) / 2 + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  cudaError_t err;
  if (ls3) {
    err = cudaFuncSetAttribute(group_wavefront_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    group_wavefront_kernel<true>
        <<<B, threads, smem, (cudaStream_t)stream>>>(args);
  } else {
    err = cudaFuncSetAttribute(group_wavefront_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    group_wavefront_kernel<false>
        <<<B, threads, smem, (cudaStream_t)stream>>>(args);
  }
  return (int)cudaGetLastError();
}
