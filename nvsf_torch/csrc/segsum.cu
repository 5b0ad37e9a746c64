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
// Columns outside [0, T) are dropped, as an XLA scatter drops them. Both
// grids are the blocks the device can hold resident (SM count x occupancy),
// grid-stride. The wrapper allocates the scratch and the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_runs.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;  // slots per transpose tile; == kThreads
constexpr int kMaxF = 32;

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
    for (int f = 0; f < kN; ++f) {
      if (f < F) {
        float x = live ? __ldcs(vals + f * ld + m) : 0.f;
        if (round_bf16) x = __bfloat162float(__float2bfloat16(x));
        v[f] = x;
      }
    }
    const nvsf::WarpRun r = nvsf::warp_runs(c, lane);
    nvsf::warp_run_sums(v, F, r, lane);
    if (!r.last || c < 0) continue;
    float* row = rows + (int64_t)c * F;
    if constexpr (kF == 2) {
      atomicAdd(reinterpret_cast<float2*>(row), make_float2(v[0], v[1]));
    } else if constexpr (kF == 8) {
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
cudaError_t launch(const int32_t* cols, const float* vals, int64_t ld,
                   float* rows, float* out, int64_t T, int64_t M, int F,
                   int round_bf16, cudaStream_t stream) {
  int64_t blocks = 0;
  cudaError_t e = cudaSuccess;
  if (M > 0) {
    e = nvsf::resident_blocks(segment_add_rows_kernel<kF>, kThreads, 0,
                              &blocks);
    if (e != cudaSuccess) return e;
    const int64_t need = (M + kThreads - 1) / kThreads;
    if (blocks > need) blocks = need;
    segment_add_rows_kernel<kF><<<(unsigned)blocks, kThreads, 0, stream>>>(
        cols, vals, ld, rows, T, M, F, round_bf16);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (T > 0 && rows != out) {
    const size_t smem = (size_t)kTile * (F + 1) * sizeof(float);
    e = nvsf::resident_blocks(segment_add_transpose_kernel<kF>, kThreads,
                              smem, &blocks);
    if (e != cudaSuccess) return e;
    const int64_t need = (T + kTile - 1) / kTile;
    if (blocks > need) blocks = need;
    segment_add_transpose_kernel<kF>
        <<<(unsigned)blocks, kThreads, smem, stream>>>(rows, out, T, F);
  }
  return cudaGetLastError();
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
