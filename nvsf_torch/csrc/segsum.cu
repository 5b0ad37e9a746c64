// Segment-add into a features-major table: out[f, cols[m]] += vals[f, m].
//
// Replaces nvsf_tpu/ops/segsum.py::_kernel_packed (the default bf16 path of
// segment_add_fm, the table gradient of every hash-grid gather) and, with
// round_bf16 = 0, nvsf_tpu/ops/segsum.py::_kernel (precision="f32").
//
// What bounds it on the H100: each update is F scattered 4-byte atomic
// read-modify-writes into a [F, T] table (up to 8 x 2^21 f32 = 64 MB, more
// than the 50 MB L2). The streamed input is only 4 * (F + 1) bytes per
// update, so the kernel is bound by the rate at which L2 retires random
// atomics and by the HBM traffic of the table lines they touch.
//
// Design: the TPU kernel sorted the updates and summed them as one-hot
// matmuls only because the TPU's scatter is serialized. Hopper retires f32
// atomics in L2, so there is no sort: one thread per update, a loop over F.
// Neighbouring threads read neighbouring updates (coalesced loads of cols
// and of each feature row of vals, whose row stride `ld` lets the caller
// pass a column slice without a copy). The atomics' results are unused, so
// they compile to fire-and-forget reductions. With round_bf16 each value is
// rounded to bf16 (round to nearest even) before it is summed in f32, as the
// TPU kernel's packed bf16 payload does. Columns outside [0, T) are dropped,
// as an XLA scatter drops them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void segment_add_kernel(const int32_t* __restrict__ cols,
                                   const float* __restrict__ vals, int64_t ld,
                                   float* __restrict__ out, int64_t T,
                                   int64_t M, int F, int round_bf16) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; m < M;
       m += stride) {
    const int64_t c = cols[m];
    if (c < 0 || c >= T) continue;
    for (int f = 0; f < F; ++f) {
      float v = vals[f * ld + m];
      if (round_bf16) v = __bfloat162float(__float2bfloat16(v));
      atomicAdd(out + f * T + c, v);
    }
  }
}

}  // namespace

extern "C" const char* nvsf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// cols: int32 [M]; vals: f32 [F, >= M] with row stride ld; out: f32 [F, T],
// zeroed by the caller. Returns cudaGetLastError() after the launch.
extern "C" int nvsf_segment_add(const void* cols, const void* vals, int64_t ld,
                                void* out, int64_t T, int64_t M, int F,
                                int round_bf16, void* stream) {
  if (M <= 0 || F <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  int64_t blocks = (M + threads - 1) / threads;
  const int64_t max_blocks = 132 * 64;  // grid-stride past this
  if (blocks > max_blocks) blocks = max_blocks;
  segment_add_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cols, (const float*)vals, ld, (float*)out, T, M, F,
      round_bf16);
  return (int)cudaGetLastError();
}
