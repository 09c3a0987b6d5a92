// The C interface of hostfn.cu, the stream host functions of the fused
// window step (bound with ctypes by ops/hostfn.py).
#pragma once

#include <stdint.h>

extern "C" {

// The service's bf_xla_plan_run and bf_probe_note (their addresses), and
// the driver's cuLaunchHostFunc.  Returns 0, or a CUDA error code.
int bf_hostfn_bind(void* plan_run, void* probe_note);

// One node's argument record (freed with bf_hostfn_free once no graph
// holds the node).
void* bf_hostfn_plan_args(int64_t plan, void* tx, void* data, uint64_t total,
                          void* status);
void* bf_hostfn_probe_args(int32_t probe_id);
void bf_hostfn_free(void* args);

// Enqueue the plan run (or the probe) of args on stream.  Returns 0, or
// the driver's error code.
int bf_hostfn_enqueue_plan(void* stream, void* args);
int bf_hostfn_enqueue_probe(void* stream, void* args);

}  // extern "C"
