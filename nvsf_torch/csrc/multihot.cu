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
// g and, for the table gradient, one atomic add per (corner, feature):
// heavily contended, since up to 262k samples land on 256..4096 columns.
//
// Design: the TPU kernels built one-hot matrices in registers and ran them
// through the MXU because the TPU has no fast gather or scatter. Hopper has
// both, so the forward is one thread per (segment, sample) with direct
// indexed loads of the segment's table. The backward gives each block one
// segment and a contiguous chunk of samples, sums the block's table
// gradient in a shared-memory copy of the segment (F * W floats; shared
// atomics are cheap and contend only within the block), and flushes it
// with one global atomic per non-zero slot. dw needs no atomics: each
// thread owns its (q, s, c, n) entries. Columns outside [0, W) contribute
// nothing.

#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void multihot_bwd_kernel(const float* __restrict__ tables,
                                    int64_t total,
                                    const int32_t* __restrict__ cols,
                                    const float* __restrict__ ws,
                                    const float* __restrict__ g,
                                    float* __restrict__ dtables,
                                    float* __restrict__ dw, int C, int F,
                                    int W, int64_t Np, int64_t chunk) {
  extern __shared__ float acc[];  // [F, W] table gradient of this segment
  const int64_t qs = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * chunk;
  const int64_t n1 = n0 + chunk < Np ? n0 + chunk : Np;
  for (int i = threadIdx.x; i < F * W; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const float* seg = tables + qs * W;
  for (int64_t n = n0 + threadIdx.x; n < n1; n += blockDim.x) {
    float gv[kMaxF];
#pragma unroll
    for (int f = 0; f < kMaxF; ++f)
      if (f < F) gv[f] = g[(qs * F + f) * Np + n];
    for (int c = 0; c < C; ++c) {
      const int64_t at = (qs * C + c) * Np + n;
      const int k = cols[at];
      if (k < 0 || k >= W) {
        if (dw) dw[at] = 0.f;
        continue;
      }
      const float w = ws[at];
      float d = 0.f;
#pragma unroll
      for (int f = 0; f < kMaxF; ++f) {
        if (f < F) {
          atomicAdd(acc + f * W + k, gv[f] * w);
          if (dw) d += seg[f * total + k] * gv[f];
        }
      }
      if (dw) dw[at] = d;
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
  const int threads = 256;
  int64_t blocks = (n_items + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  multihot_fwd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
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
  const size_t smem = (size_t)F * W * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        multihot_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = 512;
  // about four blocks per SM over all segments; each block's chunk is a
  // whole number of thread strides
  int64_t per_seg = (132 * 4 + QS - 1) / QS;
  int64_t max_per_seg = (Np + threads - 1) / threads;
  if (per_seg > max_per_seg) per_seg = max_per_seg;
  if (per_seg < 1) per_seg = 1;
  int64_t chunk = (Np + per_seg - 1) / per_seg;
  chunk = (chunk + threads - 1) / threads * threads;
  const int64_t nx = (Np + chunk - 1) / chunk;
  dim3 grid((unsigned)nx, (unsigned)QS);
  multihot_bwd_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)tables, total, (const int32_t*)cols, (const float*)ws,
      (const float*)g, (float*)dtables, (float*)dw, C, F, W, Np, chunk);
  return (int)cudaGetLastError();
}
