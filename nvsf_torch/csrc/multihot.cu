// Weighted multi-corner sampling of small per-segment tables (the K-plane
// lookups), forward and backward:
//
//   forward : out[q,s,f,n] = sum_c w[q,s,c,n] * T[f, (q*S+s)*W + cols[q,s,c,n]]
//   backward: dT[f, seg*W + cols_c[n]] += g[q,s,f,n] * w_c[n]
//             dw[q,s,c,n] = sum_f T[f, seg*W + cols_c[n]] * g[q,s,f,n]
//
// Replaces nvsf_tpu/ops/multihot.py::_fwd_kernel and ::_bwd_kernel (both the
// need_dw variant of the dynamic planes and the table-only variant of the
// coarse static planes).
//
// What bounds it on the H100: a segment table is at most F * W * 4 B =
// 128 KB (W = 4096, F = 8), so the table reads of the forward hit L1/L2 and
// the kernel streams cols, ws and out once: about (8 * C + 4 * F) bytes per
// (segment, sample), HBM-bound at 3.35 TB/s. The backward adds the read of
// g and, for the table gradient, one atomic add per (corner, feature) into
// a table of 256..4096 columns that up to 262k samples land on. The step's
// samples are ray-ordered (consecutive samples along one ray), so the 32
// lanes of a warp mostly hit the same one or two columns: contention on
// the same shared-memory word, which serializes, not bytes, bounds it.
//
// Design: the TPU kernels built one-hot matrices in registers and ran them
// through the MXU because the TPU has no fast gather or scatter. Hopper has
// both, so the forward is one thread per (segment, sample) with direct
// indexed loads of the segment's table. The backward gives each block one
// segment and a contiguous chunk of samples and sums the block's table
// gradient in a shared-memory copy of the segment (F * W floats):
//  1. Warp aggregation (warp_runs.cuh): for each corner, lanes on the same
//     column sum g[f] * w for all F in registers with a segmented shuffle
//     scan, and the run's last lane issues one shared atomic per feature
//     where the warp issued 32 serialized ones.
//  2. With the weight gradient, the block stages the segment's table in
//     shared memory beside the accumulator (F * W floats more, 8 KB for the
//     dynamic planes) when both fit, so dw = sum_f T * g reads shared memory
//     and not F scattered global loads per (corner, sample).
//  3. The grid is what the device can hold resident at the block's shared
//     memory (SM count x cudaOccupancyMaxActiveBlocksPerMultiprocessor),
//     split evenly over the segments, so each block zeroes and flushes its
//     accumulator once for a large chunk of samples, in a single wave.
// The flush is one global atomic per non-zero slot, coalesced. dw needs no
// atomics: each thread owns its (q, s, c, n) entries. Columns outside
// [0, W) contribute nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_runs.cuh"

namespace {

constexpr int kMaxC = 8;
constexpr int kMaxF = 16;

__global__ void multihot_fwd_kernel(const float* __restrict__ tables,
                                    int64_t total,
                                    const int32_t* __restrict__ cols,
                                    const float* __restrict__ ws,
                                    float* __restrict__ out, int64_t QS, int C,
                                    int F, int W, int64_t Np) {
  const int64_t n_items = QS * Np;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_items; i += stride) {
    const int64_t qs = i / Np;
    const int64_t n = i - qs * Np;
    const float* seg = tables + qs * W;
    int col[kMaxC];
    float w[kMaxC];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      if (c < C) {
        const int k = cols[(qs * C + c) * Np + n];
        const bool ok = k >= 0 && k < W;
        col[c] = ok ? k : 0;
        w[c] = ok ? ws[(qs * C + c) * Np + n] : 0.f;
      }
    }
    for (int f = 0; f < F; ++f) {
      const float* row = seg + f * total;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c)
        if (c < C) acc += w[c] * row[col[c]];
      out[(qs * F + f) * Np + n] = acc;
    }
  }
}

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 512;

// kF > 0: F is kF; kF == 0: F is the runtime argument, at most kMaxF.
// stage: copy the segment's table into shared memory for dw (needs dw).
template <int kF>
__global__ void __launch_bounds__(kBwdThreads)
    multihot_bwd_kernel(const float* __restrict__ tables, int64_t total,
                        const int32_t* __restrict__ cols,
                        const float* __restrict__ ws,
                        const float* __restrict__ g,
                        float* __restrict__ dtables, float* __restrict__ dw,
                        int C, int F_arg, int W, int64_t Np, int64_t chunk,
                        int stage) {
  constexpr int kN = kF > 0 ? kF : kMaxF;
  const int F = kF > 0 ? kF : F_arg;
  extern __shared__ float smem[];
  float* acc = smem;  // [F, W] table gradient of this segment
  const int64_t qs = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * chunk;
  const int64_t n1 = n0 + chunk < Np ? n0 + chunk : Np;
  const float* seg = tables + qs * W;
  // the table dw reads: the staged copy [F, W] or the global [F, total]
  const float* tab = seg;
  int64_t tab_ld = total;
  if (stage) {
    float* st = smem + F * W;
    for (int i = threadIdx.x; i < F * W; i += blockDim.x) {
      const int f = i / W;
      st[i] = seg[f * total + (i - f * W)];
    }
    tab = st;
    tab_ld = W;
  }
  for (int i = threadIdx.x; i < F * W; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  // warp-uniform loop: every lane takes part in the shuffles
  for (int64_t nb = n0 + (threadIdx.x & ~31); nb < n1; nb += blockDim.x) {
    const int64_t n = nb + lane;
    const bool live = n < n1;
    float gv[kN];
#pragma unroll
    for (int f = 0; f < kN; ++f)
      if (f < F) gv[f] = live ? __ldcs(g + (qs * F + f) * Np + n) : 0.f;
    for (int c = 0; c < C; ++c) {
      const int64_t at = (qs * C + c) * Np + n;
      int k = live ? __ldcs(cols + at) : -1;
      if (k < 0 || k >= W) k = -1;  // contributes nothing: one key for all
      const float w = k >= 0 ? __ldcs(ws + at) : 0.f;
      if (dw && live) {
        float d = 0.f;
        if (k >= 0) {
#pragma unroll
          for (int f = 0; f < kN; ++f)
            if (f < F) d += tab[f * tab_ld + k] * gv[f];
        }
        __stcs(dw + at, d);
      }
      float v[kN];
#pragma unroll
      for (int f = 0; f < kN; ++f)
        if (f < F) v[f] = gv[f] * w;
      const nvsf::WarpRun r = nvsf::warp_runs(k, lane);
      nvsf::warp_run_sums(v, F, r, lane);
      if (r.last && k >= 0) {
#pragma unroll
        for (int f = 0; f < kN; ++f)
          if (f < F) atomicAdd(acc + f * W + k, v[f]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < F * W; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.f) {
      const int f = i / W;
      atomicAdd(dtables + f * total + qs * W + (i - f * W), v);
    }
  }
}

template <int kF>
cudaError_t launch_bwd(const float* tables, int64_t total,
                       const int32_t* cols, const float* ws, const float* g,
                       float* dtables, float* dw, int64_t QS, int C, int F,
                       int W, int64_t Np, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return e;
  const size_t seg_bytes = (size_t)F * W * sizeof(float);
  const int stage = dw != nullptr && 2 * seg_bytes <= (size_t)optin;
  const size_t smem = seg_bytes * (stage ? 2 : 1);
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(multihot_bwd_kernel<kF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  int64_t resident = 0;
  e = nvsf::resident_blocks(multihot_bwd_kernel<kF>, kBwdThreads, smem,
                            &resident);
  if (e != cudaSuccess) return e;
  // one wave: the resident blocks split evenly over the segments, each
  // block's chunk a whole number of warps
  int64_t per_seg = resident / QS;
  const int64_t max_per_seg = (Np + 31) / 32;
  if (per_seg > max_per_seg) per_seg = max_per_seg;
  if (per_seg < 1) per_seg = 1;
  int64_t chunk = (Np + per_seg - 1) / per_seg;
  chunk = (chunk + 31) / 32 * 32;
  const int64_t nx = (Np + chunk - 1) / chunk;
  dim3 grid((unsigned)nx, (unsigned)QS);
  multihot_bwd_kernel<kF><<<grid, kBwdThreads, smem, stream>>>(
      tables, total, cols, ws, g, dtables, dw, C, F, W, Np, chunk, stage);
  return cudaGetLastError();
}

}  // namespace

// tables: f32 [F, total] with total = QS * W; cols int32 / ws f32
// [QS, C, Np]; out f32 [QS, F, Np]. Returns cudaGetLastError().
extern "C" int nvsf_multihot_fwd(const void* tables, int64_t total,
                                 const void* cols, const void* ws, void* out,
                                 int64_t QS, int C, int F, int W, int64_t Np,
                                 void* stream) {
  if (C > kMaxC || C < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const int64_t n_items = QS * Np;
  if (n_items <= 0) return (int)cudaGetLastError();
  // one thread per item up to 64 blocks per SM, grid-stride past that: a
  // grid of only the resident blocks made the forward up to 9 % slower
  int sms = 0;
  cudaError_t e = nvsf::sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  int64_t blocks = (n_items + kFwdThreads - 1) / kFwdThreads;
  if (blocks > (int64_t)sms * 64) blocks = (int64_t)sms * 64;
  multihot_fwd_kernel<<<(unsigned)blocks, kFwdThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)tables, total, (const int32_t*)cols, (const float*)ws,
      (float*)out, QS, C, F, W, Np);
  return (int)cudaGetLastError();
}

// g: f32 [QS, F, Np]; dtables: f32 [F, total], zeroed by the caller;
// dw: f32 [QS, C, Np] or null (table gradient only).
extern "C" int nvsf_multihot_bwd(const void* tables, int64_t total,
                                 const void* cols, const void* ws,
                                 const void* g, void* dtables, void* dw,
                                 int64_t QS, int C, int F, int W, int64_t Np,
                                 void* stream) {
  if (C > kMaxC || C < 1 || F > kMaxF || F < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  if (QS <= 0 || Np <= 0) return (int)cudaGetLastError();
  const auto* t = (const float*)tables;
  const auto* c = (const int32_t*)cols;
  const auto* w = (const float*)ws;
  const auto* gg = (const float*)g;
  auto* dt = (float*)dtables;
  auto* d = (float*)dw;
  auto s = (cudaStream_t)stream;
  if (F == 8)
    return (int)launch_bwd<8>(t, total, c, w, gg, dt, d, QS, C, F, W, Np, s);
  return (int)launch_bwd<0>(t, total, c, w, gg, dt, d, QS, C, F, W, Np, s);
}
