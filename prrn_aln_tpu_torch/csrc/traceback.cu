// Kernel K3: traceback walk over the group wavefront's direction planes.
//
// Replaces prrn_aln_tpu/ops/group.py::_traceback_device (a lax.while_loop
// on the TPU, vmapped by traceback_batch).  Its plain version is
// ops/group.py::traceback_ref, which walks the same lane machine on the
// host; both emit the same moves, end to start, and the same count.
//
// What bounds it on the card: one dependent chain of La + Lb to
// 3 * max_iters steps per pair, each a two-byte read of the dirs/opens
// planes at a data-dependent address: latency, not bandwidth.
//
// What the design does about it: one thread per pair walks its planes
// where K2 left them in device memory, so only the O(La + Lb) move list
// goes back to the host, never the (nsteps, nslot) planes; the pairs of
// a batch walk in parallel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int8_t L_DIAG = 0, L_VERT = 1, L_HORI = 2, L_VERT2 = 3,
                 L_HORI2 = 4;

__global__ void traceback_kernel(const int8_t* __restrict__ dirs,
                                 const int8_t* __restrict__ opens,
                                 const int32_t* __restrict__ La_,
                                 const int32_t* __restrict__ Lb_,
                                 const int32_t* __restrict__ lw_,
                                 int8_t* __restrict__ moves,
                                 int32_t* __restrict__ cnts, int B,
                                 int nsteps, int nslot, int max_iters) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int8_t* dp = dirs + (size_t)b * nsteps * nslot;
  const int8_t* op_ = opens + (size_t)b * nsteps * nslot;
  int8_t* mv = moves + (size_t)b * max_iters;
  for (int i = 0; i < max_iters; ++i) mv[i] = -1;

  int m = La_[b], n = Lb_[b];
  const int off = -(lw_[b] - 1);
  int lane = 0;               // 0=H 1=G 2=G2 3=F 4=F2
  int cnt = 0;
  for (int it = 0; (m > 0 || n > 0) && it < 3 * max_iters; ++it) {
    const int d = m + n;
    int src = -1, op = 0;
    if (d > 0 && d < nsteps) {
      // the device walk's dynamic index: negative slots wrap, then clamp
      int slot = off + (n - m);
      if (slot < 0) slot += nslot;
      slot = min(max(slot, 0), nslot - 1);
      src = dp[(size_t)d * nslot + slot];
      op = op_[(size_t)d * nslot + slot];
    }
    int emit;
    if (lane == 0) {
      if (src == L_DIAG) {
        emit = L_DIAG;
        --m;
        --n;
      } else {
        emit = -1;
        lane = src == L_VERT ? 1 : src == L_VERT2 ? 2 : src == L_HORI2 ? 4 : 3;
      }
    } else if (lane == 1 || lane == 2) {
      emit = L_VERT;
      --m;
      if ((op & (lane == 1 ? 1 : 4)) != 0 || n == 0) lane = 0;
    } else {
      emit = L_HORI;
      --n;
      if ((op & (lane == 3 ? 2 : 8)) != 0 || m == 0) lane = 0;
    }
    mv[min(cnt, max_iters - 1)] = (int8_t)emit;
    if (emit >= 0) ++cnt;
  }
  cnts[b] = min(cnt, max_iters);
}

}  // namespace

extern "C" int traceback_launch(const void* dirs, const void* opens,
                                const void* La, const void* Lb,
                                const void* lw, void* moves, void* cnts,
                                int B, int nsteps, int nslot, int max_iters,
                                void* stream) {
  const int threads = 32;
  traceback_kernel<<<(B + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const int8_t*)dirs, (const int8_t*)opens, (const int32_t*)La,
      (const int32_t*)Lb, (const int32_t*)lw, (int8_t*)moves,
      (int32_t*)cnts, B, nsteps, nslot, max_iters);
  return (int)cudaGetLastError();
}
