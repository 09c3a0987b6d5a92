// _bf_fastcall: METH_FASTCALL CPython binding for the window transport's
// per-message hot entry point.
//
// ctypes/cffi ABI-mode calls cost ~2.5 us for the 12-argument send on a
// modest host — more than the entire C++ enqueue.  This thin extension
// (built at first use when Python.h is present; everything works without
// it over ctypes, just slower) parses the arguments by hand,
// takes the payload through the buffer protocol (ZERO copy for a
// contiguous ndarray), releases the GIL across the native call (the
// enqueue may block on backpressure), and returns the raw rc.
//
// It links against the window service's library (winsvc-<hash>.so beside
// it, $ORIGIN rpath), so the bf_wintx handle created through the ctypes
// bindings is the same library instance this module enqueues into.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>

#include "bluefog_native.h"

// Bumped when the argument contract below changes; native/__init__.py
// refuses a module whose ABI does not match (a stale build must fall back
// to ctypes, never misparse arguments).
#define BF_FASTCALL_ABI 2

namespace {

// wintx_send(tx, host, port, op, name, src, dst, weight, p_weight,
//            payload, urgent, stripe) -> rc
PyObject* py_wintx_send(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != 12) {
    PyErr_SetString(PyExc_TypeError, "wintx_send expects 12 arguments");
    return nullptr;
  }
  if (!PyBytes_Check(args[1]) || !PyBytes_Check(args[4])) {
    PyErr_SetString(PyExc_TypeError, "host and name must be bytes");
    return nullptr;
  }
  void* tx = PyLong_AsVoidPtr(args[0]);
  const char* host = PyBytes_AS_STRING(args[1]);
  long port = PyLong_AsLong(args[2]);
  long op = PyLong_AsLong(args[3]);
  const char* name = PyBytes_AS_STRING(args[4]);
  long src = PyLong_AsLong(args[5]);
  long dst = PyLong_AsLong(args[6]);
  double weight = PyFloat_AsDouble(args[7]);
  double p_weight = PyFloat_AsDouble(args[8]);
  long urgent = PyLong_AsLong(args[10]);
  long stripe = PyLong_AsLong(args[11]);
  if (PyErr_Occurred()) return nullptr;
  Py_buffer view;
  if (PyObject_GetBuffer(args[9], &view, PyBUF_SIMPLE) != 0) return nullptr;
  int32_t rc;
  Py_BEGIN_ALLOW_THREADS
  rc = bf_wintx_send((bf_wintx_t*)tx, host, (int32_t)port, (uint8_t)op,
                     name, (int32_t)src, (int32_t)dst, weight, p_weight,
                     (const uint8_t*)view.buf, (uint64_t)view.len,
                     (int32_t)urgent, (int32_t)stripe);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  return PyLong_FromLong(rc);
}

PyMethodDef kMethods[] = {
    {"wintx_send", (PyCFunction)(void*)py_wintx_send, METH_FASTCALL,
     "Enqueue one window message onto the native per-peer send queue."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_bf_fastcall",
    "METH_FASTCALL hot-path bindings for the native window transport.",
    -1, kMethods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit__bf_fastcall(void) {
  PyObject* m = PyModule_Create(&kModule);
  if (m == nullptr) return nullptr;
  if (PyModule_AddIntConstant(m, "ABI_VERSION", BF_FASTCALL_ABI) != 0) {
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
