// Whether the card holds one thread-block cluster of a launch's shape,
// for the kernels launched on clusters (K1 in pairwise.cu, K1f in
// pairwise_rows.cu, K2 in group_wavefront.cu).  A host-side query only:
// including it changes no kernel.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace prrn_kernels {

// cudaOccupancyMaxActiveClusters for ``kernel`` launched as ``cfg``
// (whose first attribute is the cluster dimension), asked once a shape:
// the query takes about as long as a short launch.  One cache for the
// whole library (an inline function's statics are shared).
inline cudaError_t cluster_fits(const void* kernel,
                                const cudaLaunchConfig_t& cfg, bool* fits) {
  struct Seen {
    const void* kernel;
    unsigned ctas, threads;
    size_t smem;
    bool fits;
  };
  static std::mutex lock;
  static std::vector<Seen> seen;
  const unsigned ctas = cfg.attrs[0].val.clusterDim.x;
  std::lock_guard<std::mutex> hold(lock);
  for (const Seen& s : seen)
    if (s.kernel == kernel && s.ctas == ctas &&
        s.threads == cfg.blockDim.x && s.smem == cfg.dynamicSmemBytes) {
      *fits = s.fits;
      return cudaSuccess;
    }
  int held = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&held, kernel, &cfg);
  if (err != cudaSuccess) return err;
  *fits = held >= 1;
  seen.push_back({kernel, ctas, cfg.blockDim.x, cfg.dynamicSmemBytes, *fits});
  return cudaSuccess;
}

}  // namespace prrn_kernels
