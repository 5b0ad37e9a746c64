// Conditional IF nodes inside a CUDA graph that a stream is capturing: the
// device decides at each replay whether the node's body runs.
//
// Counterpart of one step of the JAX package's lax.while_loop over slabs in
// nvsf_tpu/render/renderer.py::_stream_composite (slab_cond / slab_body):
// the marcher's capture (nvsf_torch/render/frame_graph.py) unrolls the
// loop's K // S steps, each an IF node whose predicate, "is any ray of the
// chunk still alive", is a bool computed on the device just before it. Once
// it is false it stays false, so the skipped nodes are the loop's exit.
// The torch this port runs on exposes no conditional node to Python, so the
// node is added here through the runtime (CUDA 12.4+):
//   nvsf_graph_begin_if(stream, body_stream, pred, mode)
//     - reads the graph that `stream` is capturing and its current tail;
//     - creates a conditional handle on that graph;
//     - captures on `stream` a one-thread kernel that sets the handle from
//       the bool at `pred` (cudaGraphSetConditional);
//     - adds an IF node with one body graph after that kernel and makes it
//       the tail of `stream`'s capture;
//     - begins capturing `body_stream` into the body graph.
//   The caller then issues the body's work on `body_stream` and calls
//   nvsf_graph_end_if(body_stream), which ends that capture.
// Work after the node on `stream` waits for the node, run or skipped.
//
// What bounds it: nothing measurable; one one-thread kernel a node. Each
// returns a cudaError_t (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle,
                                const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int nvsf_graph_begin_if(void* stream, void* body_stream,
                                   const void* pred, int mode) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_conditional<<<1, 1, 0, s>>>(handle, (const bool*)pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body_stream, params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, (cudaStreamCaptureMode)mode);
}

extern "C" int nvsf_graph_end_if(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}
