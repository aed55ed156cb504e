// Kernel K4w: the fwd2h traceback walk over K4's wave-layout planes.
//
// Replaces prrn_aln_tpu/ops/pallas_spliced_h.py::_device_walk (:1016), a
// lax.while_loop on the TPU.  Its plain version is
// ops/spliced_h.py::walk_h_ref, the same state machine as a scalar
// Python loop; both emit the same knots, in backward order, and stop at
// the same cell.
//
// What bounds it on the card: one dependent chain of at most
// MAXIT = 6 (M + N + 8) steps, each a few 4-byte reads of the ev and jd
// planes at data-dependent addresses: latency, not bandwidth.
//
// What the design does about it: one thread walks the planes where K4
// left them in device memory, so only the knot list goes back to the
// host, never the T x (M + 1) planes.  The knot buffer holds 3 knots
// for each of the MAXIT steps, the most the walk can append, so it
// cannot overflow and nothing stands behind it on the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EVH_SJ = 1 << 2, EVH_JXH = 1 << 7, EVH_JXF = 1 << 8,
              EVH_JXG = 1 << 9, EVH_CSH = 1 << 10;

__global__ void spliced_h_walk_kernel(const int* __restrict__ ev,
                                      const int* __restrict__ jd,
                                      int* __restrict__ knots,
                                      int* __restrict__ out, int T, int MR,
                                      int t_min, int om, int on,
                                      int maxit) {
  auto ev_at = [&](int mm, int nn) -> int {
    const int ti = 3 * mm + nn - t_min;
    if (mm < 1 || mm >= MR || ti < 0 || ti >= T) return -1;
    return ev[(size_t)ti * MR + mm];
  };
  auto notdiag = [&](int mm, int nn) -> bool {
    const int e2 = ev_at(mm, nn);
    return mm <= 0 || e2 < 0 || (e2 & 3) != 0;
  };
  int m = om, n = on, st = 0, cnt = 0, it = 0;
  auto push = [&](int km, int kn) {
    knots[2 * cnt] = km;
    knots[2 * cnt + 1] = kn;
    ++cnt;
  };
  for (; it < maxit; ++it) {
    const int e = ev_at(m, n);
    if (m <= 0 || e < 0) break;
    const int w = e & 3;
    const bool jxh = (e & EVH_JXH) != 0, csh = (e & EVH_CSH) != 0;
    const bool b_jxh = st == 0 && w == 0 && jxh;
    const bool b_sj = st == 0 && w == 0 && !jxh && (e & EVH_SJ) != 0;
    const bool b_dg = st == 0 && w == 0 && !jxh && !b_sj;
    const bool b_jxf = st == 1 && (e & EVH_JXF) != 0;
    const bool b_h = st == 1 && !b_jxf;
    const bool b_jxg = st == 2 && (e & EVH_JXG) != 0;
    const bool b_v = st == 2 && !b_jxg;
    const int k = b_jxh ? 0 : b_sj ? 3 : b_jxf ? 1 : 2;
    const int ti = min(max(3 * m + n - t_min, 0), T - 1);
    const int mc = min(max(m, 0), MR - 1);
    const int jdv = jd[((size_t)ti * 4 + k) * MR + mc];
    const int hk = (e >> 5) & 3, vk = (e >> 3) & 3;
    if (b_jxh || b_jxf || b_jxg || b_sj || (b_dg && notdiag(m - 1, n - 3)))
      push(b_sj || b_dg ? m - 1 : m, b_sj ? jdv : b_dg ? n - 3 : n);
    if (b_jxh || b_jxf || b_jxg) push(m, jdv);
    if (b_jxh && csh && notdiag(m - 1, jdv - 3)) push(m - 1, jdv - 3);
    if (b_jxh) {
      if (csh) --m;
      n = csh ? jdv - 3 : jdv;
      st = 0;
    } else if (b_sj) {
      --m;
      n = jdv;
      st = 0;
    } else if (b_dg) {
      --m;
      n -= 3;
      st = 0;
    } else if (st == 0) {
      st = w;
    } else if (b_jxf) {
      n = jdv;
      st = 1;
    } else if (b_jxg) {
      n = jdv;
      st = 2;
    } else if (b_h) {
      n -= hk == 0 ? 3 : hk == 2 ? 2 : hk == 3 ? 3 : 1;
      st = hk == 0 ? 1 : 0;
    } else if (b_v) {
      --m;
      n -= vk == 1 ? 2 : vk == 2 ? 1 : 0;
      st = vk == 0 ? 2 : 0;
    } else {
      st = 0;
    }
  }
  out[0] = cnt;
  out[1] = m;
  out[2] = n;
  out[3] = it;
}

}  // namespace

extern "C" int spliced_h_walk_launch(const void* ev, const void* jd,
                                     void* knots, void* out, int T, int MR,
                                     int t_min, int om, int on, int maxit,
                                     void* stream) {
  spliced_h_walk_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const int*)ev, (const int*)jd, (int*)knots, (int*)out, T, MR, t_min,
      om, on, maxit);
  return (int)cudaGetLastError();
}
