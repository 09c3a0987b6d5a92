// Stream host functions of the fused window step: the put plan and the
// probe, enqueued on a CUDA stream.
//
// The fused step (ops/fused_step.py) captures its program into a CUDA
// graph.  Two pieces of it are host work, the counterparts of the JAX
// package's XLA FFI custom calls bf_xla_win_put_pass and bf_xla_probe:
//
//   * a bucket's put: bf_xla_plan_run (native/src/xlacall.cc) over the
//     pinned copy of the bucket's owned rows, which the graph's preceding
//     device-to-host copy wrote;
//   * a probe: bf_probe_note of one seam id into the native probe ring.
//
// Each is cuLaunchHostFunc on the caller's stream: under stream capture a
// host node of the graph, outside it an ordinary stream callback.  The
// host function takes no GIL and makes no CUDA call (CUDA forbids them in
// a host function).  A put writes its return code into a pinned status
// slot, which the host reads after the replay's event, so a failed put is
// raised, never swallowed.
//
// The functions reach the service's library through pointers handed to
// bf_hostfn_bind (taken from the loaded library with ctypes), so this
// library links against neither the service nor libcuda: the driver's
// cuLaunchHostFunc is found through the runtime, as flash_attention.cu
// finds cuTensorMapEncodeTiled.
//
// Arguments live in small heap records, one a node, which the caller
// keeps (and frees with bf_hostfn_free) as long as a graph holds the
// node.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>

#include "hostfn.cuh"

namespace {

typedef int32_t (*PlanRunFn)(int64_t, const void*, const float*, uint64_t);
typedef void (*ProbeNoteFn)(int32_t);
typedef CUresult (*LaunchHostFn)(CUstream, CUhostFn, void*);

PlanRunFn g_plan_run = nullptr;
ProbeNoteFn g_probe_note = nullptr;
LaunchHostFn g_launch_host = nullptr;

struct PlanArgs {
  int64_t plan;
  const void* tx;
  const float* data;
  uint64_t total;
  int32_t* status;
};

struct ProbeArgs {
  int32_t probe_id;
};

void CUDA_CB RunPlan(void* p) {
  const PlanArgs* a = static_cast<const PlanArgs*>(p);
  *a->status = g_plan_run(a->plan, a->tx, a->data, a->total);
}

void CUDA_CB NoteProbe(void* p) {
  g_probe_note(static_cast<const ProbeArgs*>(p)->probe_id);
}

}  // namespace

extern "C" {

int bf_hostfn_bind(void* plan_run, void* probe_note) {
  g_plan_run = reinterpret_cast<PlanRunFn>(plan_run);
  g_probe_note = reinterpret_cast<ProbeNoteFn>(probe_note);
  if (g_launch_host != nullptr) return 0;
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuLaunchHostFunc", &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuLaunchHostFunc", &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess) return (int)err;
  if (fn == nullptr || found != cudaDriverEntryPointSuccess) return -1;
  g_launch_host = reinterpret_cast<LaunchHostFn>(fn);
  return 0;
}

void* bf_hostfn_plan_args(int64_t plan, void* tx, void* data, uint64_t total,
                          void* status) {
  PlanArgs* a = static_cast<PlanArgs*>(malloc(sizeof(PlanArgs)));
  if (a == nullptr) return nullptr;
  a->plan = plan;
  a->tx = tx;
  a->data = static_cast<const float*>(data);
  a->total = total;
  a->status = static_cast<int32_t*>(status);
  return a;
}

void* bf_hostfn_probe_args(int32_t probe_id) {
  ProbeArgs* a = static_cast<ProbeArgs*>(malloc(sizeof(ProbeArgs)));
  if (a != nullptr) a->probe_id = probe_id;
  return a;
}

void bf_hostfn_free(void* args) { free(args); }

int bf_hostfn_enqueue_plan(void* stream, void* args) {
  if (g_launch_host == nullptr || g_plan_run == nullptr) return -1;
  return (int)g_launch_host(static_cast<CUstream>(stream), RunPlan, args);
}

int bf_hostfn_enqueue_probe(void* stream, void* args) {
  if (g_launch_host == nullptr || g_probe_note == nullptr) return -1;
  return (int)g_launch_host(static_cast<CUstream>(stream), NoteProbe, args);
}

}  // extern "C"
