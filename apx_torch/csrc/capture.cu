// The device nodes of a CUDA graph, for the port's span facility
// (apx_torch/core/trace.py): a span under a stream capture reads how many
// device nodes the graph has on entry and on exit, so its range of nodes
// comes from the graph itself and not from a count kept by hand.
//
// A device node is one that runs on the device and shows in a profiler's
// trace of a replay: a kernel, memcpy or memset node. CUDA permits every
// operation but destroy and node removal on a graph while it is being
// captured into (cudaStreamGetCaptureInfo), so reading its nodes is safe
// then. No kernel here; nothing is launched.

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

// The kernel, memcpy and memset nodes of `graph` into *nodes.
extern "C" int apx_graph_device_nodes(void* graph, long long* nodes) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t count = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &count);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> all(count);
  if (count > 0) {
    err = cudaGraphGetNodes(g, all.data(), &count);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  long long device = 0;
  for (size_t i = 0; i < count; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(all[i], &type);
    if (err != cudaSuccess) return static_cast<int>(err);
    device += type == cudaGraphNodeTypeKernel || type == cudaGraphNodeTypeMemcpy ||
              type == cudaGraphNodeTypeMemset;
  }
  *nodes = device;
  return 0;
}

// The capture `stream` is in: its id into *capture_id and the device nodes
// of the graph being captured into *nodes; 0 and -1 where the stream is
// not capturing.
extern "C" int apx_capture_nodes(void* stream, unsigned long long* capture_id, long long* nodes) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaError_t err =
      cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) {
    *capture_id = 0;
    *nodes = -1;
    return 0;
  }
  *capture_id = id;
  return apx_graph_device_nodes(graph, nodes);
}
