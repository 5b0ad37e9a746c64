// Span markers of the training path and of the U-Net refine step: one
// empty one-thread kernel for each end of each span that
// nvsf_torch/train/profiler.py names (SPANS, in the order of NVSF_SPANS
// below; a span's dots are underscores here).
//
// A span's open and close enqueue its two kernels on the caller's stream,
// so a device trace alone tells the spans apart by kernel name
// (nvsf_span_open_encode_hash ... nvsf_span_close_encode_hash) and
// orders them with the work between. On a stream that is being captured
// the launches become nodes of the graph, which every replay runs again:
// the spans survive CUDA-graph replay with no work on the host.
//   nvsf_span_mark(stream, span, open) -> cudaError_t (0 on success)
//
// What bounds it: nothing measurable; a marker is one empty kernel.

#include <cuda_runtime.h>

#define NVSF_SPANS(X)                                                     \
  X(sample) X(render) X(encode_hash) X(encode_planes) X(encode_flow)      \
  X(mlp) X(loss) X(backward) X(optim) X(refresh) X(unet_down)           \
  X(unet_attn) X(unet_up)

#define NVSF_MARKERS(ident)                                  \
  extern "C" __global__ void nvsf_span_open_##ident() {}     \
  extern "C" __global__ void nvsf_span_close_##ident() {}
NVSF_SPANS(NVSF_MARKERS)

namespace {

typedef void (*marker_t)();
#define NVSF_OPEN(ident) nvsf_span_open_##ident,
#define NVSF_CLOSE(ident) nvsf_span_close_##ident,
const marker_t kOpen[] = {NVSF_SPANS(NVSF_OPEN)};
const marker_t kClose[] = {NVSF_SPANS(NVSF_CLOSE)};
const int kCount = sizeof(kOpen) / sizeof(kOpen[0]);

}  // namespace

extern "C" int nvsf_span_mark(void* stream, int span, int open) {
  if (span < 0 || span >= kCount) return cudaErrorInvalidValue;
  const void* fn = (const void*)(open ? kOpen[span] : kClose[span]);
  return cudaLaunchKernel(fn, dim3(1), dim3(1), nullptr, 0,
                          (cudaStream_t)stream);
}
