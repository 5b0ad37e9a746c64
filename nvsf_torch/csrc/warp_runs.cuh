// Helpers shared by the scatter kernels (segsum.cu, multihot.cu): runs of
// equal keys within a warp, their sums, and the device's SM count and
// resident blocks for sizing grids.
//
// Warp aggregation: when neighbouring lanes scatter into the same slot, the
// lanes of each run of equal keys sum their values with a segmented shuffle
// scan and the run's last lane alone issues the atomics. A run is a set of
// consecutive lanes with one key; equal keys that are not neighbours stay in
// separate runs, so the result is the same for any key order and only the
// number of atomics depends on it. The scan's depth is the log2 of the
// warp's longest run, so a warp whose keys all differ pays one shuffle, one
// ballot and one warp reduction and no scan. On the inputs of a training
// step (PERF.md, tools/ablate_warp_aggregation.py) it makes B4 2.5-9x and
// B1 up to 2.7x (flow hash) faster, and B1 up to 5 % slower where
// neighbours rarely repeat (static hash). Every warp with a repeat
// aggregates: skipping the scan in warps with few repeats did not win
// those 5 % back and slowed B4, whose shared atomics serialize even a few
// equal addresses (PERF.md).
//
// Compiling with -DNVSF_NO_WARP_AGGREGATION makes every lane a run of its
// own (each lane issues its own atomics). Only
// tools/ablate_warp_aggregation.py builds that variant, to measure what the
// aggregation saves.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nvsf {

constexpr unsigned kFullMask = 0xffffffffu;

struct WarpRun {
  bool last;   // this lane ends its run and issues the run's atomics
  int start;   // the run's first lane
  int maxlen;  // the longest run of the warp (the same on every lane)
};

// Every lane of the warp must call this with its key.
__device__ __forceinline__ WarpRun warp_runs(int key, int lane) {
  WarpRun r;
#ifdef NVSF_NO_WARP_AGGREGATION
  r.last = true;
  r.start = lane;
  r.maxlen = 1;
#else
  const int prev = __shfl_up_sync(kFullMask, key, 1);
  const unsigned heads = __ballot_sync(kFullMask, lane == 0 || prev != key);
  const unsigned upto = (2u << lane) - 1u;  // lanes 0..lane (all for 31)
  r.start = 31 - __clz(heads & upto);
  const unsigned after = heads & ~upto;
  const int end = after ? __ffs(after) - 2 : 31;
  r.last = lane == end;
  r.maxlen = (int)__reduce_max_sync(kFullMask, (unsigned)(end - r.start + 1));
#endif
  return r;
}

// Inclusive sum of v[0..n) over each run: afterwards the run's last lane
// holds the run's totals. Hillis-Steele steps d = 1, 2, 4, ... while
// d < maxlen: lane i adds lane i - d's partial sum when i - d lies in its
// run. Every lane of the warp must call this; n is the same on all lanes.
template <int N>
__device__ __forceinline__ void warp_run_sums(float (&v)[N], int n,
                                              const WarpRun& r, int lane) {
  for (int d = 1; d < r.maxlen; d <<= 1) {
    const bool take = lane - d >= r.start;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < n) {
        const float u = __shfl_up_sync(kFullMask, v[i], d);
        if (take) v[i] += u;
      }
    }
  }
}

// The current device's SM count.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Blocks of `kernel` that the device can hold at once: its SM count times
// the blocks per SM at `threads` threads and `smem` bytes of dynamic shared
// memory (at least one).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                            int64_t* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t e = sm_count(&sms);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  *blocks = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

}  // namespace nvsf
