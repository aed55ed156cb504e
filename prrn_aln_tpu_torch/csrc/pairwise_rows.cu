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
//
// The score lookup.  The TPU has no gather, so it selected
// mtx[a[m], b[n]] as a one-hot (K, 32) x (32, WW) product on its matrix
// unit.  A one-hot product returns exactly one matrix entry, so here the
// same numbers come from a lookup: the pair's codes and the dim x dim
// matrix sit in shared memory and a lane reads mtx[a[m]*dim + b[n]].
// Columns outside b's array read 0, as the TPU kernel's out-of-range
// code selects its zero row.  No score image exists in device memory
// and no tensor-core product is wanted.
//
// What bounds it on the card: the chain of La rows, each closed by two
// block barriers and a two-level shuffle scan.  Device-memory traffic
// is tiny: the two code rows and the matrix.
//
// What the design does about it: one thread block per pair, so the
// batch's pairs run side by side on the 132 SMs.  Each thread owns L
// adjacent lanes (L = 1 up to 1,024 lanes).  Step 1 of a row reads the
// previous row's H and G from shared memory and forms X, the new G and
// the thread's running maximum of C + j*u; a thread recomputes X of the
// lane left of its own instead of waiting for its neighbour, which saves
// a barrier.  Warp shuffles scan the threads' maxima, one word per warp
// crosses through shared memory (barrier 1), then step 2 folds the
// carries in, masks the band and writes H and G in place (barrier 2).
// The last row is the loop's final H; the right-column candidates are a
// running maximum in the one thread that holds column lb - 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegSent = -1879048192.0f;   // -(2**31 // 8) * 7
constexpr float kNevsel = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

// inclusive running maximum over the lanes of a warp
__device__ __forceinline__ float warp_cummax(float x, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x = fmaxf(x, y);
  }
  return x;
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

__global__ void pairwise_rows_kernel(
    const int32_t* __restrict__ a_batch, const int32_t* __restrict__ b_batch,
    const int32_t* __restrict__ la_, const int32_t* __restrict__ lb_,
    const int32_t* __restrict__ lw_, const int32_t* __restrict__ up_,
    const float* __restrict__ u_, const float* __restrict__ v_,
    const float* __restrict__ tg_, const uint8_t* __restrict__ exg_,
    const float* __restrict__ mtx, float* __restrict__ out,
    int Ma, int Mb, int dim, int lw0, int W, int L) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarp = blockDim.x >> 5;
  const int La = la_[p], Lb = lb_[p], LW = lw_[p], UP = up_[p];
  const float u = u_[p], v = v_[p], tgapf = tg_[p];
  const float fa_l = exg_[4 * p + 0] ? 0.0f : tgapf;
  const float fa_r = exg_[4 * p + 1] ? 0.0f : tgapf;
  const float fb_l = exg_[4 * p + 2] ? 0.0f : tgapf;
  const float fb_r = exg_[4 * p + 3] ? 0.0f : tgapf;
  if (La <= 0) {                     // no row ever becomes the last row
    if (tid == 0) out[p] = kNevsel;
    return;
  }

  float* smtx = smem;                // dim * dim
  float* H = smtx + dim * dim;       // previous row, W lanes each
  float* G = H + W;
  float* Xs = G + W;                 // this row's X, new G, running max
  float* Gn = Xs + W;
  float* Ts = Gn + W;
  float* wtot = Ts + W;              // one carry per warp (32 words)
  uint8_t* bc = (uint8_t*)(wtot + 32);   // the pair's b codes, Mb bytes
  uint8_t* ac = bc + Mb;                 // the pair's a codes, Ma bytes

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

}  // namespace

extern "C" int pairwise_rows_launch(
    const void* a_batch, const void* b_batch, const void* la, const void* lb,
    const void* lw, const void* up, const void* u, const void* v,
    const void* tgapf, const void* exg, const void* mtx, void* out,
    int B, int Ma, int Mb, int dim, int lw0, int W, void* stream) {
  if (W < 1 || dim > 256) return (int)cudaErrorInvalidValue;
  // L adjacent lanes a thread, threads a multiple of the warp
  const int L = (W + 1023) / 1024;
  const int threads = (((W + L - 1) / L + 31) / 32) * 32;
  const size_t smem = sizeof(float) * ((size_t)dim * dim + 5 * (size_t)W + 32)
                      + (size_t)Mb + (size_t)Ma;
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  pairwise_rows_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)a_batch, (const int32_t*)b_batch, (const int32_t*)la,
      (const int32_t*)lb, (const int32_t*)lw, (const int32_t*)up,
      (const float*)u, (const float*)v, (const float*)tgapf,
      (const uint8_t*)exg, (const float*)mtx, (float*)out, Ma, Mb, dim, lw0,
      W, L);
  return (int)cudaGetLastError();
}
