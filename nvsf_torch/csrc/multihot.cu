// Weighted multi-corner sampling of small per-segment tables (the K-plane
// lookups), forward and backward:
//
//   forward : out[q,s,f,n] = sum_c w[q,s,c,n] * T[f, (q*S+s)*W + cols[q,s,c,n]]
//   backward: dT[f, seg*W + cols_c[n]] += g[q,s,f,n] * w_c[n]
//             dw[q,s,c,n] = sum_f T[f, seg*W + cols_c[n]] * g[q,s,f,n]
//
// Replaces nvsf_tpu/ops/multihot.py::_fwd_kernel and ::_bwd_kernel (both the
// need_dw variant of the dynamic planes and the table-only variant of the
// coarse static planes). The TPU kernels built [W, 512] one-hot matrices and
// ran them through the MXU because the TPU has no fast gather or scatter: W/C
// times the useful flops (1024x for the static planes, 128x for the dynamic
// ones). Hopper has both, so neither kernel uses the tensor cores; both are
// about memory layout and the number of requests.
//
// Forward. What bounds it on the H100: the HBM stream of cols, ws and out,
// (8 * C + 4 * F) bytes per (segment, sample): 64 B for the static planes
// (C 4, F 8), 48 B for the dynamic ones (C 2). The tables are small (a
// static segment is F * W * 4 B = 128 KB, a folded dynamic one 8 KB) but
// features-major: a corner's F features lie in F lines, so reading them
// there costs C * F scalar requests per sample, and the segments (768 KB
// static, 288 KB dynamic) outgrow an SM's L1. Design:
//  1. Corners are read row-major, F contiguous floats: two 16-byte loads for
//     F = 8. Each block stages its segment in shared memory as [W][F],
//     transposing while it stores, then streams a chunk of the segment's
//     samples. A segment must fit in a block's shared memory (F * W * 4 B
//     up to 227 KB, as for the backward's accumulator); every segment of
//     the field does. Staging beat reading a row-major copy of the tables
//     through L1/L2, its transposing pass included, at every shape of the
//     step and the render (PERF.md), so there is no other path.
//  2. Launch rule: the grid is one wave of the blocks the device holds
//     resident at the segment's shared memory, split evenly over the
//     segments, and no block gets fewer samples than one pass of its
//     threads (2,048). That is what tells the step from the render: the
//     step's static planes (196,608 or 262,144 samples a segment, one
//     128 KB block an SM) get 22 blocks a segment of 8,940-11,916 samples;
//     the render's slab (32,768 samples) 16 blocks a segment of 2,048, one
//     pass each.
//  3. Each thread takes 4 consecutive samples of one segment, with 32-bit
//     indices inside the segment: int4/float4 loads of cols and ws and one
//     float4 store of out per feature, all streaming (__ldcs/__stcs: out is
//     half the stream of the static planes and two thirds of the dynamic
//     ones', and write-back stores, which keep it in L2, were slower at
//     every shape tried). Rows start at (q*S+s)*C*Np, so that
//     takes Np % 4 == 0 and 16-byte aligned pointers; otherwise each
//     thread takes one sample at a time.
//  4. With F = 8 a lane loads the half (lane & 1) of its corner row first,
//     so that the 16-byte shared loads of neighbouring lanes on random
//     columns fall in different banks (on the step's ray-ordered samples,
//     lanes mostly share a column and the loads broadcast). Other F (up to
//     16) take scalar loads of the row.
// Columns outside [0, W) contribute nothing.
//
// Backward. What bounds it: one atomic add per (corner, feature) into a
// table of 256..4096 columns that up to 262k samples land on. The step's
// samples are ray-ordered (consecutive samples along one ray), so the 32
// lanes of a warp mostly hit the same one or two columns: contention on
// the same shared-memory word, which serializes, not bytes, bounds it.
// Design: each block takes one segment and a contiguous chunk of samples
// and sums the block's table gradient in a shared-memory copy of the
// segment (F * W floats):
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
constexpr int kFwdThreads = 512;

// kV consecutive entries of a streamed row (a 16-byte load for kV = 4).
template <int kV>
__device__ __forceinline__ void load_stream(const int32_t* p, int (&v)[kV]) {
  if constexpr (kV == 4) {
    const int4 x = __ldcs(reinterpret_cast<const int4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i) v[i] = __ldcs(p + i);
  }
}

template <int kV>
__device__ __forceinline__ void load_stream(const float* p, float (&v)[kV]) {
  if constexpr (kV == 4) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i) v[i] = __ldcs(p + i);
  }
}

// Block (x, qs) computes samples [x * chunk, (x + 1) * chunk) of segment qs
// from the segment staged in shared memory as [W][F] (F * W floats).
// kF/kC > 0: F/C are kF/kC; 0: the runtime arguments. kV: samples a thread
// takes at once (4 needs Np % 4 == 0, chunk % 4 == 0 and aligned pointers).
template <int kF, int kC, int kV>
__global__ void __launch_bounds__(kFwdThreads)
    multihot_fwd_kernel(const float* __restrict__ tables, int64_t total,
                        const int32_t* __restrict__ cols,
                        const float* __restrict__ ws, float* __restrict__ out,
                        int C_arg, int F_arg, int W, int Np, int chunk) {
  constexpr int kNF = kF > 0 ? kF : kMaxF;
  constexpr int kNC = kC > 0 ? kC : kMaxC;
  const int F = kF > 0 ? kF : F_arg;
  const int C = kC > 0 ? kC : C_arg;
  extern __shared__ __align__(16) float tab[];
  const int64_t qs = blockIdx.y;
  const float* seg = tables + qs * W;
  for (int j = threadIdx.x; j < W; j += kFwdThreads) {
    float v[kNF];
#pragma unroll
    for (int f = 0; f < kNF; ++f)
      if (f < F) v[f] = __ldg(seg + f * total + j);
    float* r = tab + j * F;
    if constexpr (kF == 8) {
      reinterpret_cast<float4*>(r)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(r)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int f = 0; f < kNF; ++f)
        if (f < F) r[f] = v[f];
    }
  }
  __syncthreads();
  const int32_t* cs = cols + qs * C * Np;
  const float* wsg = ws + qs * C * Np;
  float* os = out + qs * F * Np;
  const int n0 = blockIdx.x * chunk;
  const int n1 = Np - n0 < chunk ? Np : n0 + chunk;
  // F = 8: acc[s][0..4) sums the half of the row this lane loads first
  const int h = kF == 8 ? (threadIdx.x & 1) : 0;
  for (int n = n0 + threadIdx.x * kV; n < n1; n += kFwdThreads * kV) {
    float acc[kV][kNF];
#pragma unroll
    for (int s = 0; s < kV; ++s)
#pragma unroll
      for (int f = 0; f < kNF; ++f) acc[s][f] = 0.f;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      if (c < C) {
        int k[kV];
        float w[kV];
        load_stream<kV>(cs + c * Np + n, k);
        load_stream<kV>(wsg + c * Np + n, w);
#pragma unroll
        for (int s = 0; s < kV; ++s) {
          const bool ok = (unsigned)k[s] < (unsigned)W;
          const float wv = ok ? w[s] : 0.f;
          const float* r = tab + (ok ? k[s] : 0) * F;
          if constexpr (kF == 8) {
            const float4 a = *reinterpret_cast<const float4*>(r + 4 * h);
            const float4 b = *reinterpret_cast<const float4*>(r + 4 - 4 * h);
            acc[s][0] += wv * a.x;
            acc[s][1] += wv * a.y;
            acc[s][2] += wv * a.z;
            acc[s][3] += wv * a.w;
            acc[s][4] += wv * b.x;
            acc[s][5] += wv * b.y;
            acc[s][6] += wv * b.z;
            acc[s][7] += wv * b.w;
          } else {
#pragma unroll
            for (int f = 0; f < kNF; ++f)
              if (f < F) acc[s][f] += wv * r[f];
          }
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kNF; ++f) {
      if (f < F) {
        // F = 8: feature f sits at acc[.][f ^ 4] on lanes that loaded the
        // upper half first
        float v[kV];
#pragma unroll
        for (int s = 0; s < kV; ++s)
          v[s] = kF == 8 && h ? acc[s][f ^ 4] : acc[s][f];
        float* o = os + f * Np + n;
        if constexpr (kV == 4)
          __stcs(reinterpret_cast<float4*>(o),
                 make_float4(v[0], v[1], v[2], v[3]));
        else
          __stcs(o, v[0]);
      }
    }
  }
}

// Blocks of one forward kernel resident on device `dev` at `smem` bytes of
// shared memory. Each thread keeps its last answer per kernel: the occupancy
// query and the shared-memory attribute cost the host more than the launch,
// and the field calls each kernel at one size. The attribute fails for a
// segment larger than a block's shared memory can hold.
template <int kF, int kC, int kV>
cudaError_t resident_fwd(int dev, size_t smem, int64_t* resident) {
  static thread_local int last_dev = -1;
  static thread_local size_t last_smem = 0;
  static thread_local int64_t last = 0;
  if (dev != last_dev || smem != last_smem) {
    auto kernel = multihot_fwd_kernel<kF, kC, kV>;
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = nvsf::resident_blocks(kernel, kFwdThreads, smem, &last);
    if (e != cudaSuccess) {
      last_dev = -1;
      return e;
    }
    last_dev = dev;
    last_smem = smem;
  }
  *resident = last;
  return cudaSuccess;
}

template <int kF, int kC, int kV>
cudaError_t launch_fwd(const float* tables, int64_t total, const int32_t* cols,
                       const float* ws, float* out, int64_t QS, int C, int F,
                       int W, int64_t Np, cudaStream_t stream) {
  const size_t smem = (size_t)F * W * sizeof(float);
  int dev = 0;
  int64_t resident = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = resident_fwd<kF, kC, kV>(dev, smem, &resident);
  if (e != cudaSuccess) return e;
  // one wave split over the segments; at least one pass of the threads each
  int64_t per_seg = resident / QS;
  const int64_t pass = (int64_t)kFwdThreads * kV;
  const int64_t max_per_seg = (Np + pass - 1) / pass;
  if (per_seg > max_per_seg) per_seg = max_per_seg;
  if (per_seg < 1) per_seg = 1;
  int64_t chunk = (Np + per_seg - 1) / per_seg;
  chunk = (chunk + kV - 1) / kV * kV;
  const dim3 grid((unsigned)((Np + chunk - 1) / chunk), (unsigned)QS);
  multihot_fwd_kernel<kF, kC, kV><<<grid, kFwdThreads, smem, stream>>>(
      tables, total, cols, ws, out, C, F, W, (int)Np, (int)chunk);
  return cudaGetLastError();
}

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

// tables: f32 [F, total] with total = QS * W, F * W * 4 B at most a block's
// shared memory; cols int32 / ws f32 [QS, C, Np]; out f32 [QS, F, Np].
// Picks the instantiation for (F, C) and the sample vector width. Returns
// cudaGetLastError().
extern "C" int nvsf_multihot_fwd(const void* tables, int64_t total,
                                 const void* cols, const void* ws, void* out,
                                 int64_t QS, int C, int F, int W, int64_t Np,
                                 void* stream) {
  if (C > kMaxC || C < 1 || F > kMaxF || F < 1 || W < 1 || QS > 65535 ||
      (int64_t)(C > F ? C : F) * Np >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if (QS <= 0 || Np <= 0) return (int)cudaGetLastError();
  const auto* t = (const float*)tables;
  const auto* c = (const int32_t*)cols;
  const auto* w = (const float*)ws;
  auto* o = (float*)out;
  auto s = (cudaStream_t)stream;
  const bool vec = Np % 4 == 0 && ((uintptr_t)cols | (uintptr_t)ws |
                                   (uintptr_t)out) % 16 == 0;
  if (vec && F == 8 && C == 4)
    return (int)launch_fwd<8, 4, 4>(t, total, c, w, o, QS, C, F, W, Np, s);
  if (vec && F == 8 && C == 2)
    return (int)launch_fwd<8, 2, 4>(t, total, c, w, o, QS, C, F, W, Np, s);
  if (vec)
    return (int)launch_fwd<0, 0, 4>(t, total, c, w, o, QS, C, F, W, Np, s);
  return (int)launch_fwd<0, 0, 1>(t, total, c, w, o, QS, C, F, W, Np, s);
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
