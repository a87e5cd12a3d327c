// A CUDA graph conditional IF node, added to a graph under stream capture
// (mast3r_slam_torch/graphs.py `if_node`).
//
// It replaces jax.lax.cond in the JAX package's chained tracking step
// (mast3r_slam_tpu/tracker.py:469, the keyframe promotion): inside one
// compiled window program, the promotion's mono decode runs only on frames
// whose keyframe decision `new_kf` is set on the device. PyTorch records no
// conditional node when it captures a graph, so this file adds one to the
// graph that the stream is capturing:
//
//   [ work captured so far ] -> set_if_kernel (reads *pred) -> IF node { body }
//                            -> [ work captured after ]
//
//   * cudaGraphConditionalHandleCreate makes the IF node's handle in the
//     capturing graph (from cudaStreamGetCaptureInfo), reset to 0 at every
//     launch of the graph;
//   * set_if_kernel, one thread, is captured on the stream and sets the
//     handle from the device-side predicate with cudaGraphSetConditional, so
//     the decision never travels to the host;
//   * cudaGraphAddNode adds the IF node after the kernel, and the body graph
//     it returns receives a copy of `body` (a graph captured by PyTorch on
//     its own, with its own memory) as a child graph node;
//   * cudaStreamUpdateCaptureDependencies makes everything captured on the
//     stream afterwards depend on the IF node.
//
// What bounds it: nothing to speak of. The setter kernel reads one byte and
// its launch is a node of the graph; the IF node costs the device a few
// microseconds whether or not the body runs (measured in chip_smoke.py's
// phase 18, beside the select form that would run the body every time).
// Needs CUDA 12.4 or later (conditional nodes; the device-side setter).

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const unsigned char* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps, size_t* ndeps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, nullptr, ndeps);
#else
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, ndeps);
#endif
}

}  // namespace

// Adds, to the graph that `stream` is capturing, the setter kernel reading
// the bool (one byte) at device pointer `pred` and an IF node whose body is a
// copy of the graph `body` (a cudaGraph_t). Returns a cudaError_t.
extern "C" int graph_cond_if(void* stream_ptr, const void* pred, void* body) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t e = capture_info(stream, &status, &graph, &deps, &ndeps);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureUnmatched;

  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return e;
  set_if_kernel<<<1, 1, 0, stream>>>(handle, static_cast<const unsigned char*>(pred));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = capture_info(stream, &status, &graph, &deps, &ndeps);  // now the setter kernel
  if (e != cudaSuccess) return e;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
  if (e != cudaSuccess) return e;
  cudaGraphNode_t child;
  e = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0], nullptr, 0,
                                 static_cast<cudaGraph_t>(body));
  if (e != cudaSuccess) return e;
#if CUDART_VERSION >= 13000
  return cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                             cudaStreamSetCaptureDependencies);
#else
  return cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
#endif
}
