// C API for the inference predictor — native shim over embedded CPython.
//
// Reference parity: paddle/fluid/inference/capi_exp/ (the PD_* C ABI that
// lets C/C++/Go serving stacks drive AnalysisPredictor). The port's own
// copy of the JAX package's shim: the predictor runs a torch.export
// program (its attention the CUDA kernel K1 on a card), so the C layer
// embeds a CPython interpreter (or joins the already-running one when
// loaded into a Python process) and marshals buffers to
// paddle_tpu_torch.inference.capi_bridge. No business logic lives in C++.
//
// Thread model: every entry point takes the GIL via PyGILState_Ensure —
// safe to call from any thread of a C host program.

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

std::mutex g_mu;
std::string g_last_error;
bool g_we_initialized = false;

void set_error(const char* where) {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = where;
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      msg += ": ";
      msg += PyUnicode_AsUTF8(s);
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  std::lock_guard<std::mutex> g(g_mu);
  g_last_error = msg;
}

PyObject* bridge() {
  // fresh import each call is a dict lookup after the first time
  return PyImport_ImportModule("paddle_tpu_torch.inference.capi_bridge");
}

struct GIL {
  PyGILState_STATE st;
  GIL() : st(PyGILState_Ensure()) {}
  ~GIL() { PyGILState_Release(st); }
};

}  // namespace

extern "C" {

// Initialize (or join) the interpreter. `pythonpath_prepend` may be NULL;
// pass the repo root when driving from a standalone C program.
int PD_Init(const char* pythonpath_prepend) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = true;
    // the embedded interpreter starts on this thread holding the GIL;
    // release it so GIL{} guards work uniformly afterwards
    PyEval_SaveThread();
  }
  GIL gil;
  if (pythonpath_prepend && *pythonpath_prepend) {
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    PyObject* p = PyUnicode_FromString(pythonpath_prepend);
    if (sys_path && p) PyList_Insert(sys_path, 0, p);
    Py_XDECREF(p);
  }
  PyObject* m = bridge();
  if (!m) {
    set_error("PD_Init: import paddle_tpu_torch.inference.capi_bridge");
    return -1;
  }
  Py_DECREF(m);
  return 0;
}

const char* PD_GetLastError(void) {
  std::lock_guard<std::mutex> g(g_mu);
  return g_last_error.c_str();
}

// Returns predictor handle > 0, or 0 on failure.
int64_t PD_PredictorCreate(const char* model_prefix, const char* device) {
  GIL gil;
  PyObject* m = bridge();
  if (!m) {
    set_error("import bridge");
    return 0;
  }
  PyObject* r = PyObject_CallMethod(m, "create_predictor", "ss", model_prefix,
                                    device ? device : "gpu");
  Py_DECREF(m);
  if (!r) {
    set_error("PD_PredictorCreate");
    return 0;
  }
  int64_t h = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return h;
}

void PD_PredictorDestroy(int64_t handle) {
  GIL gil;
  PyObject* m = bridge();
  if (!m) return;
  PyObject* r = PyObject_CallMethod(m, "destroy_predictor", "L", handle);
  Py_XDECREF(r);
  Py_DECREF(m);
  if (!r) PyErr_Clear();
}

// Writes up to `max_names` NUL-terminated names into user buffers of
// `name_cap` bytes each; returns input count or -1.
int PD_PredictorGetInputNames(int64_t handle, char** names, int max_names,
                              int name_cap) {
  GIL gil;
  PyObject* m = bridge();
  if (!m) {
    set_error("import bridge");
    return -1;
  }
  PyObject* r = PyObject_CallMethod(m, "input_names", "L", handle);
  Py_DECREF(m);
  if (!r) {
    set_error("PD_PredictorGetInputNames");
    return -1;
  }
  int n = static_cast<int>(PyList_Size(r));
  for (int i = 0; i < n && i < max_names; ++i) {
    const char* s = PyUnicode_AsUTF8(PyList_GetItem(r, i));
    std::strncpy(names[i], s ? s : "", name_cap - 1);
    names[i][name_cap - 1] = '\0';
  }
  Py_DECREF(r);
  return n;
}

// dtype: "float32", "int64", ... matching numpy names.
int PD_PredictorSetInput(int64_t handle, const char* name, const void* data,
                         const int64_t* dims, int ndim, const char* dtype) {
  GIL gil;
  int64_t numel = 1;
  for (int i = 0; i < ndim; ++i) numel *= dims[i];
  int64_t itemsize;
  if (std::strcmp(dtype, "float64") == 0 || std::strcmp(dtype, "int64") == 0 ||
      std::strcmp(dtype, "uint64") == 0 || std::strcmp(dtype, "complex64") == 0)
    itemsize = 8;
  else if (std::strcmp(dtype, "float32") == 0 ||
           std::strcmp(dtype, "int32") == 0 ||
           std::strcmp(dtype, "uint32") == 0)
    itemsize = 4;
  else if (std::strcmp(dtype, "float16") == 0 ||
           std::strcmp(dtype, "bfloat16") == 0 ||
           std::strcmp(dtype, "int16") == 0 ||
           std::strcmp(dtype, "uint16") == 0)
    itemsize = 2;
  else if (std::strcmp(dtype, "int8") == 0 || std::strcmp(dtype, "uint8") == 0 ||
           std::strcmp(dtype, "bool") == 0)
    itemsize = 1;
  else {
    std::lock_guard<std::mutex> g(g_mu);
    g_last_error = std::string("PD_PredictorSetInput: unknown dtype ") + dtype;
    return -1;
  }
  PyObject* mv = PyMemoryView_FromMemory(
      const_cast<char*>(static_cast<const char*>(data)), numel * itemsize,
      PyBUF_READ);
  PyObject* dimlist = PyList_New(ndim);
  for (int i = 0; i < ndim; ++i)
    PyList_SetItem(dimlist, i, PyLong_FromLongLong(dims[i]));
  PyObject* m = bridge();
  PyObject* r = m ? PyObject_CallMethod(m, "set_input", "LsOOs", handle, name,
                                        mv, dimlist, dtype)
                  : nullptr;
  Py_XDECREF(m);
  Py_XDECREF(mv);
  Py_XDECREF(dimlist);
  if (!r) {
    set_error("PD_PredictorSetInput");
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

// Returns number of outputs, or -1.
int PD_PredictorRun(int64_t handle) {
  GIL gil;
  PyObject* m = bridge();
  PyObject* r =
      m ? PyObject_CallMethod(m, "run", "L", handle) : nullptr;
  Py_XDECREF(m);
  if (!r) {
    set_error("PD_PredictorRun");
    return -1;
  }
  int n = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return n;
}

// Returns ndim (and fills dims up to max_ndim), or -1.
int PD_PredictorGetOutputDims(int64_t handle, int idx, int64_t* dims,
                              int max_ndim) {
  GIL gil;
  PyObject* m = bridge();
  PyObject* r =
      m ? PyObject_CallMethod(m, "output_dims", "Li", handle, idx) : nullptr;
  Py_XDECREF(m);
  if (!r) {
    set_error("PD_PredictorGetOutputDims");
    return -1;
  }
  int n = static_cast<int>(PyList_Size(r));
  for (int i = 0; i < n && i < max_ndim; ++i)
    dims[i] = PyLong_AsLongLong(PyList_GetItem(r, i));
  Py_DECREF(r);
  return n;
}

// Writes the numpy dtype name into `out` (cap bytes); returns 0 or -1.
int PD_PredictorGetOutputDtype(int64_t handle, int idx, char* out, int cap) {
  GIL gil;
  PyObject* m = bridge();
  PyObject* r =
      m ? PyObject_CallMethod(m, "output_dtype", "Li", handle, idx) : nullptr;
  Py_XDECREF(m);
  if (!r) {
    set_error("PD_PredictorGetOutputDtype");
    return -1;
  }
  const char* s = PyUnicode_AsUTF8(r);
  std::strncpy(out, s ? s : "", cap - 1);
  out[cap - 1] = '\0';
  Py_DECREF(r);
  return 0;
}

// Copies output idx into `out` (must hold the full tensor). Returns bytes
// written, or -1.
int64_t PD_PredictorCopyOutput(int64_t handle, int idx, void* out,
                               int64_t out_bytes) {
  GIL gil;
  PyObject* mv = PyMemoryView_FromMemory(static_cast<char*>(out), out_bytes,
                                         PyBUF_WRITE);
  PyObject* m = bridge();
  PyObject* r = m ? PyObject_CallMethod(m, "copy_output", "LiO", handle, idx,
                                        mv)
                  : nullptr;
  Py_XDECREF(m);
  Py_XDECREF(mv);
  if (!r) {
    set_error("PD_PredictorCopyOutput");
    return -1;
  }
  int64_t n = PyLong_AsLongLong(r);
  Py_DECREF(r);
  return n;
}

void PD_Finalize(void) {
  if (g_we_initialized && Py_IsInitialized()) {
    PyGILState_Ensure();
    Py_Finalize();
    g_we_initialized = false;
  }
}

}  // extern "C"
