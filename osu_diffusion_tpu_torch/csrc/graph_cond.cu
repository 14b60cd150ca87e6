// Conditional IF nodes in a CUDA graph that PyTorch is capturing from a
// stream (CUDA 12.4 or later): what torch.cuda.CUDAGraph's
// begin_capture_to_if_node / end_capture_to_conditional_node do in the
// PyTorch builds that have them, for the builds that do not.
//
// graph_if_begin, called while `capturing` is being captured: creates a
// conditional handle in the graph under capture, captures a one-thread
// kernel that sets it from the bool at `pred` (read when the graph runs),
// adds an IF node after it, makes that node the stream's capture
// dependency, and begins capturing `body` into the node's body graph.
// Whatever is then launched on `body` runs, at a replay, only where *pred
// is true. graph_if_end ends the body's capture. Nothing here launches
// work outside a capture. Each entry returns a cudaError_t (0: success).

#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "conditional graph nodes need CUDA 12.4 or later"
#endif

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// CUDA 13 gave these three their edge-data parameter in the default names
cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, nullptr, n);
#else
  return cudaStreamGetCaptureInfo(s, status, nullptr, graph, deps, n);
#endif
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* deps, size_t n,
                     cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, deps, nullptr, n, params);
#else
  return cudaGraphAddNode(node, graph, deps, n, params);
#endif
}

cudaError_t set_dependency(cudaStream_t s, cudaGraphNode_t* node) {
#if CUDART_VERSION >= 13000
  return cudaStreamUpdateCaptureDependencies(s, node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  return cudaStreamUpdateCaptureDependencies(s, node, 1, cudaStreamSetCaptureDependencies);
#endif
}

}  // namespace

extern "C" int graph_stream_create(void** out) {
  cudaStream_t s = nullptr;
  const cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return static_cast<int>(e);
}

extern "C" int graph_if_begin(void* capturing, void* body, const void* pred) {
  cudaStream_t s = static_cast<cudaStream_t>(capturing);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t e = capture_info(s, &status, &graph, &deps, &n);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorStreamCaptureInvalidated);
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  set_condition_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  e = cudaGetLastError();
  if (e == cudaSuccess) e = capture_info(s, &status, &graph, &deps, &n);  // now the kernel's node
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = add_node(&node, graph, deps, n, &params);
  if (e == cudaSuccess) e = set_dependency(s, &node);
  if (e == cudaSuccess) {
    e = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
                                      nullptr, nullptr, 0, cudaStreamCaptureModeGlobal);
  }
  return static_cast<int>(e);
}

extern "C" int graph_if_end(void* body) {
  cudaGraph_t graph;  // the IF node's body graph, owned by the node
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph));
}

extern "C" const char* graph_cond_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
