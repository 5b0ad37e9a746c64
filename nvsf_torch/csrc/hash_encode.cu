// Hash-grid lookup, forward: out[n, l*F + f] = sum_c w_c * table[slot_c, f]
// over the 2^D corners c of point n at level l, for up to kMaxLookups
// lookups (points, table, output slice) in one launch.
//
// Replaces no Pallas kernel: the JAX package computes the corners, hashes
// and weights as XLA ops (nvsf_tpu/models/hash_grid.py), gathers through
// nvsf_tpu/ops/gather.py::table_gather and reduces the corners; its
// gradient was B1. Ported, that was a chain of small PyTorch kernels
// writing int64 corners [N, L, C, D], two index chains, weights [L, C, N]
// and gathered values [F, L*C*N] to memory (nvsf_torch/ops/hash_lookup.py::
// lookup_plain, kept as the plain version and the CPU path).
//
// What bounds it on the H100: the work is 2^D scattered reads of a slot's
// F features per (point, level); the streamed bytes are the points read
// once and [N, L*F] written once. The tables (4 x 2^19 x 8 f32 = 64 MB at
// the shipped static width) are read through L2 a sector per corner, so
// the rate of scattered L2 requests bounds it before the bytes do: at the
// cells' shapes it runs at 7-23 % of the byte bound, the least where a
// corner uses 4 bytes of its sector (F = 1; PERF.md).
//
// Design. One thread per (point, level): it scales its point (hash_grid.cuh,
// the arithmetic of the plain version), computes each corner's slot and
// weight in registers, reads the corner's F features with vector loads
// from a row-major [slots, F] table (one 32-byte sector for F <= 8; a
// feature count outside the cells' {1, 2, 4, 8, 32} takes scalar loads) and
// sums the weighted corners in f32 in corner order; only the [N, L*F]
// output reaches memory. A block is one (lookup, level) (blockIdx.y), so
// the level's constants are uniform and a warp's lanes are neighbouring
// points at one level: ray-ordered samples share the coarse levels'
// corners, which one load instruction then fetches once. The lookups'
// descriptors are kernel parameters passed by value (__grid_constant__),
// so a launch inside a captured CUDA graph copies nothing from the host.
// A features-major table (feat_ld != 1) is read with scalar loads, F
// sectors a corner: the layout the wrapper measures against.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"

namespace {

constexpr int kThreads = 256;

// kF > 0: F is kF; kF == 0: F is the runtime argument (at most
// kMaxFeatures, held in arrays of that size), read with scalar loads.
template <int kF, int kN>
__device__ __forceinline__ void load_slot(const float* __restrict__ row,
                                          int64_t feat_ld, bool rows, int F,
                                          float (&v)[kN]) {
  if constexpr (kF > 0 && kF % 4 == 0) {
    if (rows) {
#pragma unroll
      for (int f = 0; f < kF; f += 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(row + f));
        v[f] = q.x;
        v[f + 1] = q.y;
        v[f + 2] = q.z;
        v[f + 3] = q.w;
      }
      return;
    }
  } else if constexpr (kF == 2) {
    if (rows) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(row));
      v[0] = q.x;
      v[1] = q.y;
      return;
    }
  }
#pragma unroll
  for (int f = 0; f < kN; ++f)
    if (f < F) v[f] = __ldg(row + f * feat_ld);
}

template <int kF, int kN>
__device__ __forceinline__ void store_row(float* __restrict__ out, int F,
                                          const float (&v)[kN]) {
  if constexpr (kF > 0 && kF % 4 == 0) {
#pragma unroll
    for (int f = 0; f < kF; f += 4)
      *reinterpret_cast<float4*>(out + f) =
          make_float4(v[f], v[f + 1], v[f + 2], v[f + 3]);
  } else if constexpr (kF == 2) {
    *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int f = 0; f < kN; ++f)
      if (f < F) out[f] = v[f];
  }
}

template <int D, int kF>
__global__ void __launch_bounds__(kThreads)
    hash_gather_fwd_kernel(const __grid_constant__ nvsf::HashLookups p) {
  constexpr int kN = kF > 0 ? kF : nvsf::kMaxFeatures;
  const int F = kF > 0 ? kF : p.F;
  const nvsf::HashLevel v = nvsf::hash_level(p);
  const auto& lk = v.lk;
  const bool rows = lk.feat_ld == 1 && lk.slot_ld == F;
  const float* table =
      reinterpret_cast<const float*>(lk.table) + v.l * v.T * lk.slot_ld;
  float* out = reinterpret_cast<float*>(lk.out) + v.l * F;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; n < lk.n;
       n += stride) {
    const nvsf::HashPoint<D> pt = nvsf::hash_point<D>(v, n);
    float acc[kN];
#pragma unroll
    for (int f = 0; f < kN; ++f) acc[f] = 0.f;
#pragma unroll
    for (int u = 0; u < (1 << D); ++u) {
      float w;
      const int slot = nvsf::hash_corner<D>(pt, v, u, &w);
      float val[kN];
      load_slot<kF, kN>(table + slot * lk.slot_ld, lk.feat_ld, rows, F, val);
#pragma unroll
      for (int f = 0; f < kN; ++f)
        if (f < F) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, val[f]));
    }
    store_row<kF, kN>(out + n * lk.out_ld, F, acc);
  }
}

template <int D, int kF>
cudaError_t launch(const nvsf::HashLookups& p, int n_lookups, int64_t max_n,
                   cudaStream_t stream) {
  const int64_t blocks = (max_n + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(blocks < (1 << 20) ? blocks : (1 << 20)),
                  (unsigned)(n_lookups * p.L));
  hash_gather_fwd_kernel<D, kF><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The cells' feature counts have their own instantiations; any other F
// runs the runtime-F one.
template <int D>
cudaError_t launch_d(const nvsf::HashLookups& p, int n_lookups, int64_t max_n,
                     cudaStream_t s) {
  switch (p.F) {
    case 1: return launch<D, 1>(p, n_lookups, max_n, s);
    case 2: return launch<D, 2>(p, n_lookups, max_n, s);
    case 4: return launch<D, 4>(p, n_lookups, max_n, s);
    case 8: return launch<D, 8>(p, n_lookups, max_n, s);
    case 32: return launch<D, 32>(p, n_lookups, max_n, s);
    default: return launch<D, 0>(p, n_lookups, max_n, s);
  }
}

}  // namespace

// lookups: int64 [n_lookups, kLookupWords] (nvsf::HashLookup, host memory);
// res: int32 [L] (host memory). D in {2, 3}, 1 <= F <= 32, L <= 16,
// n_lookups <= 12. A row-major table (feat_ld 1, slot_ld F) must be aligned
// to min(F, 4) floats for F in {2, 4, 8, 32}; each output row likewise. Writes every
// lookup's [n, L*F] output; returns cudaGetLastError() after the launch.
extern "C" int nvsf_hash_encode_fwd(const void* lookups, int n_lookups,
                                    const void* res, int L, int D, int F,
                                    void* stream) {
  if (n_lookups < 0 || n_lookups > nvsf::kMaxLookups || L < 1 ||
      L > nvsf::kMaxLevels || F < 1 || F > nvsf::kMaxFeatures)
    return (int)cudaErrorInvalidValue;
  nvsf::HashLookups p;
  const auto* lk = (const nvsf::HashLookup*)lookups;
  int64_t max_n = 0;
  for (int k = 0; k < n_lookups; ++k) {
    p.lk[k] = lk[k];
    if (lk[k].n > max_n) max_n = lk[k].n;
  }
  for (int l = 0; l < L; ++l) p.res[l] = ((const int*)res)[l];
  p.L = L;
  p.F = F;
  if (max_n == 0) return (int)cudaGetLastError();
  auto s = (cudaStream_t)stream;
  switch (D) {
    case 2: return (int)launch_d<2>(p, n_lookups, max_n, s);
    case 3: return (int)launch_d<3>(p, n_lookups, max_n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
