// Segment-add into a features-major table: out[f, cols[m]] += vals[f, m].
//
// Replaces nvsf_tpu/ops/segsum.py::_kernel_packed (the default bf16 path of
// segment_add_fm, the table gradient of every hash-grid gather) and, with
// round_bf16 = 0, nvsf_tpu/ops/segsum.py::_kernel (precision="f32").
//
// What bounds it on the H100: the work is one scattered read-modify-write of
// the F values of a slot per update; the streamed input is only
// 4 * (F + 1) bytes per update. So the kernel is bound by the rate at which
// L2 retires scattered atomics, and by the HBM traffic of the table sectors
// they touch when the table outgrows the 50 MB L2 (static hash: 8 x 2^21 f32
// = 64 MB), not by the bytes of the work (each input read once, the output
// written once), which would take a few times less (PERF.md).
//
// Design. The TPU kernel sorted the updates and summed one-hot products on
// the MXU only because the TPU serializes scatters; Hopper retires f32
// atomics in L2, so there is no sort. A features-major table puts the F
// values of one slot 4T bytes apart, so an update there is F scalar atomics
// into F lines. Instead:
//  1. segment_add_rows_kernel accumulates into a zeroed row-major scratch
//     [T, F]: one thread per update reads cols[m] and vals[:, m] (coalesced;
//     the row stride `ld` lets the caller pass a column slice without a
//     copy), rounds to bf16 where asked (round to nearest even, as the TPU
//     kernel's packed payload), and adds the slot's F values with vector
//     atomics into one 32-byte sector: two float4 for F = 8 (the static and
//     flow hash grids), one float2 for F = 2 (the dynamic ones; sm_90,
//     global memory). Any other F adds scalar atomics on the same row.
//  2. Warp aggregation (warp_runs.cuh): cols are ordered [level, corner,
//     sample] and the step's samples are ray-ordered, so neighbouring updates
//     share a slot at the coarse levels; each run of equal columns is summed
//     in registers and issues one row of atomics. On inputs with no repeated
//     neighbour it costs one shuffle, one ballot and one reduction per warp.
//     On a step's inputs it makes the flow hash's gradient 1.4-2.3x faster
//     and the static hash's, whose neighbours rarely repeat, a few per cent
//     slower (tools/ablate_warp_aggregation.py, PERF.md); one kernel serves
//     both, and the note in warp_runs.cuh says why every warp with a
//     repeat aggregates.
//  3. segment_add_transpose_kernel turns [T, F] into [F, T] through
//     shared-memory tiles of 256 slots, coalesced on both sides
//     (2 x 4FT bytes: 128 MB at the static hash, ~0.04 ms at the HBM rate).
//     At F = 1 the two layouts are one: the wrapper passes the zeroed output
//     as the scratch and there is no transpose. F = 1 also gets its own
//     instantiation, which holds one value a thread in registers instead of
//     the runtime-F path's 32-entry arrays (the reference widths' dynamic
//     hash tables: 4 features over 4 time bases).
//  4. The hash-grid lookup's gradient (nvsf_hash_encode_bwd) is the same
//     rows stage with another input stage: instead of reading cols and
//     vals, each thread recomputes one (point, level)'s corner slots and
//     weights from the saved points (hash_grid.cuh, the forward's
//     arithmetic), reads the level's F incoming gradients once, and issues
//     each corner's update w_c * g (rounded as above) through the same
//     warp aggregation and vector atomics. Lanes hold neighbouring points
//     of one (level, corner), the [level, corner, sample] order of the
//     cols/vals entry, so the runs are the same; no cols, weights or
//     per-corner values reach memory. Then the same transpose, or none
//     where the table is row-major itself (the folded tables). The cells'
//     F in {1, 2, 4, 8, 32} have their own instantiations, any other F up
//     to 32 the runtime-F one (scalar atomics), so every lookup on the
//     card runs this stage.
// Columns outside [0, T) are dropped, as an XLA scatter drops them. Both
// grids are the blocks the device can hold resident (SM count x occupancy),
// grid-stride. The wrapper allocates the scratch and the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_grid.cuh"
#include "warp_runs.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;  // slots per transpose tile; == kThreads
constexpr int kMaxF = 32;
static_assert(nvsf::kMaxFeatures == kMaxF, "one runtime-F width");

template <int kN>
__device__ __forceinline__ void round_to_bf16(float (&v)[kN], int F) {
#pragma unroll
  for (int f = 0; f < kN; ++f)
    if (f < F) v[f] = __bfloat162float(__float2bfloat16(v[f]));
}

// Sums each warp run of equal keys c (c < 0: nothing to add) and adds the
// run's F values to row c of `rows` [*, F] from its last lane.
template <int kF, int kN>
__device__ __forceinline__ void add_to_row(int c, float (&v)[kN], int F,
                                           float* __restrict__ rows,
                                           int lane) {
  const nvsf::WarpRun r = nvsf::warp_runs(c, lane);
  nvsf::warp_run_sums(v, F, r, lane);
  if (!r.last || c < 0) return;
  float* row = rows + (int64_t)c * F;
  if constexpr (kF == 2) {
    atomicAdd(reinterpret_cast<float2*>(row), make_float2(v[0], v[1]));
  } else if constexpr (kF > 0 && kF % 4 == 0) {
#pragma unroll
    for (int f = 0; f < kF; f += 4)
      atomicAdd(reinterpret_cast<float4*>(row + f),
                make_float4(v[f], v[f + 1], v[f + 2], v[f + 3]));
  } else {
#pragma unroll
    for (int f = 0; f < kN; ++f)
      if (f < F) atomicAdd(row + f, v[f]);
  }
}

// kF > 0: F is kF; kF == 0: F is the runtime argument, at most kMaxF.
template <int kF>
__global__ void __launch_bounds__(kThreads)
    segment_add_rows_kernel(const int32_t* __restrict__ cols,
                            const float* __restrict__ vals, int64_t ld,
                            float* __restrict__ rows, int64_t T, int64_t M,
                            int F_arg, int round_bf16) {
  constexpr int kN = kF > 0 ? kF : kMaxF;
  const int F = kF > 0 ? kF : F_arg;
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // warp-uniform loop: every lane takes part in the shuffles
  for (int64_t m0 = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       m0 < M; m0 += stride) {
    const int64_t m = m0 + lane;
    const bool live = m < M;
    int c = live ? __ldcs(cols + m) : -1;
    if (c < 0 || c >= T) c = -1;  // dropped: one key for all of them
    float v[kN];
#pragma unroll
    for (int f = 0; f < kN; ++f)
      if (f < F) v[f] = live ? __ldcs(vals + f * ld + m) : 0.f;
    if (round_bf16) round_to_bf16(v, F);
    add_to_row<kF>(c, v, F, rows, lane);
  }
}

// The hash-grid lookup's input stage: block (lookup, level) = blockIdx.y,
// one thread a point, its 2^kD corners in turn. Each lookup's `table` is
// its slot 0 in the rows scratch, its `out` the incoming gradient's first
// column. kF == 0: F is p.F, at most kMaxF.
template <int kF, int kD>
__global__ void __launch_bounds__(kThreads)
    segment_add_rows_kernel(const __grid_constant__ nvsf::HashLookups p,
                            int round_bf16) {
  constexpr int kN = kF > 0 ? kF : kMaxF;
  const int F = kF > 0 ? kF : p.F;
  const nvsf::HashLevel v = nvsf::hash_level(p);
  const auto& lk = v.lk;
  float* rows = reinterpret_cast<float*>(lk.table) + v.l * v.T * F;
  const float* g = reinterpret_cast<const float*>(lk.out) + v.l * F;
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t n0 = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
       n0 < lk.n; n0 += stride) {
    const int64_t n = n0 + lane;
    const bool live = n < lk.n;
    nvsf::HashPoint<kD> pt = {};
    float gn[kN];
#pragma unroll
    for (int f = 0; f < kN; ++f) gn[f] = 0.f;
    if (live) {
      pt = nvsf::hash_point<kD>(v, n);
#pragma unroll
      for (int f = 0; f < kN; ++f)
        if (f < F) gn[f] = __ldg(g + n * lk.out_ld + f);
    }
#pragma unroll 1
    for (int u = 0; u < (1 << kD); ++u) {
      float w = 0.f;
      const int c = live ? nvsf::hash_corner<kD>(pt, v, u, &w) : -1;
      float upd[kN];
#pragma unroll
      for (int f = 0; f < kN; ++f) upd[f] = live ? __fmul_rn(w, gn[f]) : 0.f;
      if (round_bf16) round_to_bf16(upd, F);
      add_to_row<kF>(c, upd, F, rows, lane);
    }
  }
}

// rows [T, F] -> out [F, T], one tile of kTile slots per step of the loop.
template <int kF>
__global__ void __launch_bounds__(kThreads)
    segment_add_transpose_kernel(const float* __restrict__ rows,
                                 float* __restrict__ out, int64_t T,
                                 int F_arg) {
  extern __shared__ float tile[];  // [kTile][F + 1]: odd pitch, no conflicts
  const int F = kF > 0 ? kF : F_arg;
  const int64_t n_tiles = (T + kTile - 1) / kTile;
  for (int64_t b = blockIdx.x; b < n_tiles; b += gridDim.x) {
    const int64_t t0 = b * kTile;
    const int n = T - t0 < kTile ? (int)(T - t0) : kTile;
    const float* src = rows + t0 * F;
    for (int i = threadIdx.x; i < n * F; i += kThreads) {
      const int j = i / F;
      tile[j * (F + 1) + (i - j * F)] = __ldcs(src + i);
    }
    __syncthreads();
    const int j = threadIdx.x;
    if (j < n)
      for (int f = 0; f < F; ++f) __stcs(out + f * T + t0 + j,
                                         tile[j * (F + 1) + f]);
    __syncthreads();
  }
}

template <int kF>
cudaError_t transpose(const float* rows, float* out, int64_t T, int F,
                      cudaStream_t stream) {
  if (T == 0 || rows == out) return cudaGetLastError();
  const size_t smem = (size_t)kTile * (F + 1) * sizeof(float);
  int64_t blocks = 0;
  cudaError_t e = nvsf::resident_blocks(segment_add_transpose_kernel<kF>,
                                        kThreads, smem, &blocks);
  if (e != cudaSuccess) return e;
  const int64_t need = (T + kTile - 1) / kTile;
  if (blocks > need) blocks = need;
  segment_add_transpose_kernel<kF>
      <<<(unsigned)blocks, kThreads, smem, stream>>>(rows, out, T, F);
  return cudaGetLastError();
}

template <int kF>
cudaError_t launch(const int32_t* cols, const float* vals, int64_t ld,
                   float* rows, float* out, int64_t T, int64_t M, int F,
                   int round_bf16, cudaStream_t stream) {
  if (M > 0) {
    // the cols/vals overload (the hash lookup's shares the kernel's name)
    void (*kernel)(const int32_t*, const float*, int64_t, float*, int64_t,
                   int64_t, int, int) = segment_add_rows_kernel<kF>;
    int64_t blocks = 0;
    cudaError_t e = nvsf::resident_blocks(kernel, kThreads, 0, &blocks);
    if (e != cudaSuccess) return e;
    const int64_t need = (M + kThreads - 1) / kThreads;
    if (blocks > need) blocks = need;
    kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(cols, vals, ld, rows, T,
                                                      M, F, round_bf16);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return transpose<kF>(rows, out, T, F, stream);
}

// The hash lookup's gradient: the rows stage over (lookup, level) blocks,
// then the transpose (the runtime-F one for F outside {2, 8}).
template <int kF, int kD>
cudaError_t launch_hash(const nvsf::HashLookups& p, int n_lookups,
                        int64_t max_n, float* rows, float* out, int64_t T,
                        int round_bf16, cudaStream_t stream) {
  const int64_t blocks = (max_n + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(blocks < (1 << 20) ? blocks : (1 << 20)),
                  (unsigned)(n_lookups * p.L));
  segment_add_rows_kernel<kF, kD><<<grid, kThreads, 0, stream>>>(p,
                                                                 round_bf16);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int kT = kF == 2 || kF == 8 ? kF : 0;
  return transpose<kT>(rows, out, T, p.F, stream);
}

// The cells' feature counts have their own instantiations; any other F
// runs the runtime-F one.
template <int kD>
cudaError_t launch_hash_d(const nvsf::HashLookups& p, int n_lookups,
                          int64_t max_n, float* rows, float* out, int64_t T,
                          int round_bf16, cudaStream_t s) {
  switch (p.F) {
    case 1: return launch_hash<1, kD>(p, n_lookups, max_n, rows, out, T,
                                      round_bf16, s);
    case 2: return launch_hash<2, kD>(p, n_lookups, max_n, rows, out, T,
                                      round_bf16, s);
    case 4: return launch_hash<4, kD>(p, n_lookups, max_n, rows, out, T,
                                      round_bf16, s);
    case 8: return launch_hash<8, kD>(p, n_lookups, max_n, rows, out, T,
                                      round_bf16, s);
    case 32: return launch_hash<32, kD>(p, n_lookups, max_n, rows, out, T,
                                        round_bf16, s);
    default: return launch_hash<0, kD>(p, n_lookups, max_n, rows, out, T,
                                       round_bf16, s);
  }
}

}  // namespace

extern "C" const char* nvsf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// cols: int32 [M]; vals: f32 [F, >= M] with row stride ld; rows: f32 [T, F]
// scratch, zeroed by the caller; out: f32 [F, T], written whole. F <= 32.
// rows == out (F = 1 only, zeroed by the caller) accumulates in place.
// Returns cudaGetLastError() after the launches.
extern "C" int nvsf_segment_add(const void* cols, const void* vals, int64_t ld,
                                void* rows, void* out, int64_t T, int64_t M,
                                int F, int round_bf16, void* stream) {
  if (F < 0 || F > kMaxF || T < 0) return (int)cudaErrorInvalidValue;
  if (F == 0) return (int)cudaGetLastError();
  if (rows == out && F != 1) return (int)cudaErrorInvalidValue;
  const auto* c = (const int32_t*)cols;
  const auto* v = (const float*)vals;
  auto* r = (float*)rows;
  auto* o = (float*)out;
  auto s = (cudaStream_t)stream;
  switch (F) {
    case 1: return (int)launch<1>(c, v, ld, r, o, T, M, F, round_bf16, s);
    case 2: return (int)launch<2>(c, v, ld, r, o, T, M, F, round_bf16, s);
    case 8: return (int)launch<8>(c, v, ld, r, o, T, M, F, round_bf16, s);
    default: return (int)launch<0>(c, v, ld, r, o, T, M, F, round_bf16, s);
  }
}

// The gradient of nvsf_hash_encode_fwd (hash_encode.cu) into one table of T
// slots. lookups: int64 [n_lookups, kLookupWords] (host memory), each with
// `table` pointing at its slot 0 in `rows` (f32 [T, F], zeroed by the
// caller) and `out` at its first column of the incoming gradient; res:
// int32 [L] (host memory). D in {2, 3}, 1 <= F <= 32. out: f32
// [F, T], written whole, or rows itself (a row-major table, or F = 1):
// no transpose. Returns cudaGetLastError() after the launches.
extern "C" int nvsf_hash_encode_bwd(const void* lookups, int n_lookups,
                                    const void* res, int L, int D, int F,
                                    void* rows, void* out, int64_t T,
                                    int round_bf16, void* stream) {
  if (n_lookups < 0 || n_lookups > nvsf::kMaxLookups || L < 1 ||
      L > nvsf::kMaxLevels || T < 0 || F < 1 || F > kMaxF)
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
  auto* r = (float*)rows;
  auto* o = (float*)out;
  auto s = (cudaStream_t)stream;
  if (max_n == 0) {  // nothing to add: the zeroed rows, transposed
    switch (F) {
      case 2: return (int)transpose<2>(r, o, T, F, s);
      case 8: return (int)transpose<8>(r, o, T, F, s);
      default: return (int)transpose<0>(r, o, T, F, s);
    }
  }
  switch (D) {
    case 2: return (int)launch_hash_d<2>(p, n_lookups, max_n, r, o, T,
                                         round_bf16, s);
    case 3: return (int)launch_hash_d<3>(p, n_lookups, max_n, r, o, T,
                                         round_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
