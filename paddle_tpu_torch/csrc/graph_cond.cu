// The WHILE conditional node of a captured CUDA graph, for NVIDIA Hopper
// (sm_90a), CUDA C++.
//
// Replaces no Pallas kernel. The JAX package compiles a tensor `while`
// (static.nn.while_loop on a traced predicate, and the loops dy2static
// converts) to lax.while_loop inside one XLA program
// (paddle_tpu/static/nn/control_flow.py:315), and a tensor cond, case or
// switch_case to lax.cond/lax.switch (:188). The port captures a step as
// one CUDA graph (jit/static_function.py), and a graph holds control flow
// whose predicate is data only as conditional nodes: an IF node runs its
// body graph once when its condition value is non-zero, a WHILE node runs
// it while the value is non-zero, and a kernel in the graph sets that
// value from device memory. The PyTorch of the card (2.11) exposes
// neither, so this file adds both, with one capture protocol.
//
// What it does. On the stream being captured (the caller's current
// stream):
//   1. create a conditional handle in the graph being captured
//      (cudaGraphConditionalHandleCreate);
//   2. capture a one-thread kernel that reads the 0-d bool predicate from
//      device memory and sets the handle (cudaGraphSetConditional);
//   3. add a cudaGraphCondTypeIf or cudaGraphCondTypeWhile node after the
//      capture's current
//      dependencies (cudaGraphAddNode) and make it the capture's only
//      dependency (cudaStreamUpdateCaptureDependencies), so what the caller
//      captures next runs after the loop;
//   4. begin capturing a second stream, the body stream, into the node's
//      body graph (cudaStreamBeginCaptureToGraph).
// The caller then runs the body on the body stream and ends the body's
// capture (ptc_cond_end). A WHILE body first writes the new carry back
// into the carry buffers, computes the next predicate and captures the
// same one-thread kernel on the body stream (ptc_set_conditional). At
// replay an IF node runs its body when the predicate holds; a WHILE node
// runs it while the predicate it last read holds: zero trips when it is
// false before the loop.
//
// What bounds it. The set kernel reads one byte: one launch of a single
// thread a trip, latency and not bytes or operations. A trip of a real
// body (a forward step) is the body's own time.
//
// Interface: plain C functions returning cudaError_t, bound with ctypes.
// Nothing here falls back: a runtime or driver without conditional nodes
// (CUDA < 12.4) returns its error and the caller raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

// Steps 1-4 above. `stream` is being captured; `body_stream` is not.
// `is_while` selects a WHILE node, else an IF node. The handle is written
// to *handle_out for ptc_set_conditional.
cudaError_t ptc_cond_begin(void* stream, void* body_stream, const void* pred,
                           int is_while, unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStream_t body = static_cast<cudaStream_t>(body_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_conditional_kernel<<<1, 1, 0, s>>>(handle,
                                         static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  cudaGraph_t body_graph = params.conditional.phGraph_out[0];
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(body, body_graph, nullptr, nullptr, 0,
                                      cudaStreamCaptureModeGlobal);
  if (err != cudaSuccess) return err;
  *handle_out = static_cast<unsigned long long>(handle);
  return cudaSuccess;
}

// Captures the set kernel on `stream`: the node's condition becomes *pred.
cudaError_t ptc_set_conditional(void* stream, unsigned long long handle,
                                const void* pred) {
  set_conditional_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle),
      static_cast<const bool*>(pred));
  return cudaGetLastError();
}

// Ends the body's capture (the body graph belongs to the node).
cudaError_t ptc_cond_end(void* body_stream) {
  cudaGraph_t g;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &g);
}

}  // extern "C"
