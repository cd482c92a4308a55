// Conditional (IF) nodes inside a CUDA graph that a stream is capturing,
// for PyTorch builds whose CUDAGraph has no conditional-node API.
//
// cond_begin_if, called while `capture` captures: a conditional handle in
// the graph being captured; a one-thread kernel, captured on `capture`,
// that sets the handle to (*code == value); an IF node depending on what
// the stream captured so far, which becomes the stream's only dependency;
// and `body` starts capturing into the IF node's body graph.  Work launched
// on `body` until cond_end runs only when the condition holds at replay.
// IF nodes need CUDA 12.4 (runtime and driver).  Every call returns a
// cudaError_t (0 = success); nothing here synchronizes or allocates.
#include <cuda_runtime.h>

namespace {

__global__ void set_if(cudaGraphConditionalHandle handle,
                       const long long* code, long long value) {
  cudaGraphSetConditional(handle, *code == value ? 1u : 0u);
}

}  // namespace

extern "C" int cond_begin_if(void* capture, const void* code,
                             long long value, void* body, int mode) {
  const cudaStream_t s = static_cast<cudaStream_t>(capture);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t e =
      cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  set_if<<<1, 1, 0, s>>>(handle, static_cast<const long long*>(code), value);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the set kernel is now the stream's dependency
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, static_cast<cudaStreamCaptureMode>(mode));
}

extern "C" int cond_end(void* body) {
  cudaGraph_t graph;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}

// A stream for IF bodies: non-blocking, never destroyed by this library.
extern "C" int cond_stream_create(void** out) {
  cudaStream_t s;
  const cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return (int)e;
}

extern "C" const char* cond_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
