// The flat C ABI over mxnet_tpu_torch: MXNet's standalone inference
// surface (c_predict_api: MXPredCreate / SetInput / Forward /
// GetOutputShape / GetOutput / Free, MXGetLastError, MXGetVersion), the
// training subset (MXNDArray*, MXSymbol*, MXExecutor*) and op dispatch
// (MXListAllOpNames, NNGetOpHandle, MXImperativeInvoke[Ex]).
//
// The library embeds CPython and forwards each call to
// mxnet_tpu_torch/capi_shim.py, which keeps the handle table and the
// float32 marshalling.  A host that already runs an interpreter (a
// ctypes caller) reuses it; a standalone C program initializes one, which
// must then find torch and the repository (PYTHONPATH, and PYTHONHOME
// where the interpreter is a venv's: mxnet_tpu_torch._build.capi_env()).
// Built by mxnet_tpu_torch._build.capi_library() with g++ and the running
// interpreter's include and link flags; it holds no CUDA code.
//
// Devices: dev_type 1 is the CPU and 2 is cuda:<dev_id>; MXPredCreate,
// MXNDArrayCreate and MXExecutorBind pass them to the shim.
//
// Every function returns 0 on success and -1 on failure; MXGetLastError()
// returns the message (thread-local).

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

typedef uint32_t mx_uint;
typedef void *PredictorHandle;

static thread_local std::string g_last_error;
static std::mutex g_init_mutex;

struct MXPredState {
  long shim_handle;
  // backing store for MXPredGetOutputShape pointers (per reference
  // semantics the pointers stay valid until the next call on the handle)
  std::vector<mx_uint> shape_buf;
};

static void set_error(const std::string &msg) { g_last_error = msg; }

static void capture_py_error() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = "python error";
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      msg = PyUnicode_AsUTF8(s) ? PyUnicode_AsUTF8(s) : msg;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

static bool ensure_python() {
  std::lock_guard<std::mutex> lk(g_init_mutex);
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    // release the GIL acquired by initialization; every entry point
    // below re-acquires via PyGILState_Ensure
    PyEval_SaveThread();
  }
  return true;
}

namespace {
class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};
}  // namespace

static PyObject *shim() {
  static PyObject *mod = nullptr;  // borrowed forever once imported
  if (!mod) {
    mod = PyImport_ImportModule("mxnet_tpu_torch.capi_shim");
  }
  return mod;
}

extern "C" {

const char *MXGetLastError() { return g_last_error.c_str(); }

int MXGetVersion(int *out) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject *m = shim();
  if (!m) {
    capture_py_error();
    return -1;
  }
  PyObject *r = PyObject_CallMethod(m, "version", nullptr);
  if (!r) {
    capture_py_error();
    return -1;
  }
  *out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int MXPredCreate(const char *symbol_json_file, const char *param_file,
                 int dev_type, int dev_id, mx_uint num_input_nodes,
                 const char **input_keys, const mx_uint *input_shape_indptr,
                 const mx_uint *input_shape_data, PredictorHandle *out) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject *m = shim();
  if (!m) {
    capture_py_error();
    return -1;
  }
  PyObject *keys = PyList_New(num_input_nodes);
  PyObject *indptr = PyList_New(num_input_nodes + 1);
  for (mx_uint i = 0; i < num_input_nodes; ++i)
    PyList_SetItem(keys, i, PyUnicode_FromString(input_keys[i]));
  for (mx_uint i = 0; i <= num_input_nodes; ++i)
    PyList_SetItem(indptr, i,
                   PyLong_FromUnsignedLong(input_shape_indptr[i]));
  mx_uint n_dims = input_shape_indptr[num_input_nodes];
  PyObject *dims = PyList_New(n_dims);
  for (mx_uint i = 0; i < n_dims; ++i)
    PyList_SetItem(dims, i, PyLong_FromUnsignedLong(input_shape_data[i]));
  PyObject *r = PyObject_CallMethod(
      m, "create", "ssOOOii", symbol_json_file,
      param_file ? param_file : "", keys, indptr, dims, dev_type, dev_id);
  Py_DECREF(keys);
  Py_DECREF(indptr);
  Py_DECREF(dims);
  if (!r) {
    capture_py_error();
    return -1;
  }
  auto *st = new MXPredState();
  st->shim_handle = PyLong_AsLong(r);
  Py_DECREF(r);
  *out = st;
  return 0;
}

int MXPredSetInput(PredictorHandle handle, const char *key,
                   const float *data, mx_uint size) {
  Gil gil;
  auto *st = static_cast<MXPredState *>(handle);
  PyObject *buf = PyBytes_FromStringAndSize(
      reinterpret_cast<const char *>(data),
      static_cast<Py_ssize_t>(size) * sizeof(float));
  PyObject *r = PyObject_CallMethod(shim(), "set_input", "lsO",
                                    st->shim_handle, key, buf);
  Py_DECREF(buf);
  if (!r) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int MXPredForward(PredictorHandle handle) {
  Gil gil;
  auto *st = static_cast<MXPredState *>(handle);
  PyObject *r =
      PyObject_CallMethod(shim(), "forward", "l", st->shim_handle);
  if (!r) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int MXPredGetNumOutputs(PredictorHandle handle, mx_uint *out) {
  Gil gil;
  auto *st = static_cast<MXPredState *>(handle);
  PyObject *r =
      PyObject_CallMethod(shim(), "num_outputs", "l", st->shim_handle);
  if (!r) {
    capture_py_error();
    return -1;
  }
  *out = static_cast<mx_uint>(PyLong_AsUnsignedLong(r));
  Py_DECREF(r);
  return 0;
}

int MXPredGetOutputShape(PredictorHandle handle, mx_uint index,
                         mx_uint **shape_data, mx_uint *shape_ndim) {
  Gil gil;
  auto *st = static_cast<MXPredState *>(handle);
  PyObject *r = PyObject_CallMethod(shim(), "output_shape", "lI",
                                    st->shim_handle, index);
  if (!r) {
    capture_py_error();
    return -1;
  }
  Py_ssize_t n = PyTuple_Size(r);
  st->shape_buf.resize(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i)
    st->shape_buf[static_cast<size_t>(i)] = static_cast<mx_uint>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(r, i)));
  Py_DECREF(r);
  *shape_data = st->shape_buf.data();
  *shape_ndim = static_cast<mx_uint>(n);
  return 0;
}

int MXPredGetOutput(PredictorHandle handle, mx_uint index, float *data,
                    mx_uint size) {
  Gil gil;
  auto *st = static_cast<MXPredState *>(handle);
  PyObject *r = PyObject_CallMethod(shim(), "output_bytes", "lI",
                                    st->shim_handle, index);
  if (!r) {
    capture_py_error();
    return -1;
  }
  char *buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(r, &buf, &len) != 0) {
    Py_DECREF(r);
    capture_py_error();
    return -1;
  }
  if (static_cast<Py_ssize_t>(size) * 4 < len) {
    Py_DECREF(r);
    set_error("MXPredGetOutput: buffer too small");
    return -1;
  }
  std::memcpy(data, buf, static_cast<size_t>(len));
  Py_DECREF(r);
  return 0;
}

int MXPredFree(PredictorHandle handle) {
  Gil gil;
  auto *st = static_cast<MXPredState *>(handle);
  PyObject *r = PyObject_CallMethod(shim(), "free", "l", st->shim_handle);
  if (!r) {
    capture_py_error();
    delete st;
    return -1;
  }
  Py_DECREF(r);
  delete st;
  return 0;
}

}  // extern "C"

// ========================================================================
// The training subset (MXNet's src/c_api/c_api.cc: MXNDArray* /
// MXSymbol* / MXExecutor*), float32: enough for a C host to run a train
// loop: create arrays, copy in and out, bind, forward, backward, read
// the gradients.
// ========================================================================

typedef void *NDArrayHandle;
typedef void *SymbolHandle;
typedef void *ExecutorHandle;

struct MXNDState {
  long shim_handle;
  std::vector<mx_uint> shape_buf;  // MXNDArrayGetShape backing store
};

struct MXSymState {
  long shim_handle;
  // MXSymbolInferShape backing stores (valid until next call, per
  // reference semantics)
  std::vector<std::vector<mx_uint>> shapes;
  std::vector<mx_uint> ndims[3];
  std::vector<const mx_uint *> datas[3];
};

struct MXExecState {
  long shim_handle;
};

// call a shim function returning a long handle; -1 on python error
static long call_long(PyObject *r) {
  if (!r) {
    capture_py_error();
    return -1;
  }
  long v = PyLong_AsLong(r);
  Py_DECREF(r);
  return v;
}

extern "C" {

int MXNDArrayCreate(const mx_uint *shape, mx_uint ndim, int dev_type,
                    int dev_id, int delay_alloc, NDArrayHandle *out) {
  (void)delay_alloc;
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject *shp = PyList_New(ndim);
  for (mx_uint i = 0; i < ndim; ++i)
    PyList_SetItem(shp, i, PyLong_FromUnsignedLong(shape[i]));
  long h = call_long(PyObject_CallMethod(shim(), "nd_create", "Oii", shp,
                                         dev_type, dev_id));
  Py_DECREF(shp);
  if (h < 0) return -1;
  auto *st = new MXNDState();
  st->shim_handle = h;
  *out = st;
  return 0;
}

int MXNDArrayFree(NDArrayHandle handle) {
  Gil gil;
  auto *st = static_cast<MXNDState *>(handle);
  PyObject *r =
      PyObject_CallMethod(shim(), "nd_free", "l", st->shim_handle);
  Py_XDECREF(r);
  delete st;
  return r ? 0 : (capture_py_error(), -1);
}

// `size` counts ELEMENTS (reference semantics), not bytes
int MXNDArraySyncCopyFromCPU(NDArrayHandle handle, const void *data,
                             size_t size) {
  Gil gil;
  auto *st = static_cast<MXNDState *>(handle);
  PyObject *buf = PyBytes_FromStringAndSize(
      static_cast<const char *>(data),
      static_cast<Py_ssize_t>(size * sizeof(float)));
  PyObject *r = PyObject_CallMethod(shim(), "nd_sync_copy_from", "lO",
                                    st->shim_handle, buf);
  Py_DECREF(buf);
  if (!r) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int MXNDArraySyncCopyToCPU(NDArrayHandle handle, void *data, size_t size) {
  Gil gil;
  auto *st = static_cast<MXNDState *>(handle);
  PyObject *r = PyObject_CallMethod(shim(), "nd_sync_copy_to", "l",
                                    st->shim_handle);
  if (!r) {
    capture_py_error();
    return -1;
  }
  char *buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(r, &buf, &len) != 0) {
    Py_DECREF(r);
    capture_py_error();
    return -1;
  }
  if (static_cast<Py_ssize_t>(size * sizeof(float)) != len) {
    Py_DECREF(r);
    set_error("MXNDArraySyncCopyToCPU: size mismatch (" +
              std::to_string(size) + " elements requested, array has " +
              std::to_string(len / sizeof(float)) + ")");
    return -1;
  }
  std::memcpy(data, buf, static_cast<size_t>(len));
  Py_DECREF(r);
  return 0;
}

int MXNDArrayGetShape(NDArrayHandle handle, mx_uint *out_dim,
                      const mx_uint **out_pdata) {
  Gil gil;
  auto *st = static_cast<MXNDState *>(handle);
  PyObject *r = PyObject_CallMethod(shim(), "nd_get_shape", "l",
                                    st->shim_handle);
  if (!r) {
    capture_py_error();
    return -1;
  }
  Py_ssize_t n = PyTuple_Size(r);
  st->shape_buf.resize(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i)
    st->shape_buf[static_cast<size_t>(i)] = static_cast<mx_uint>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(r, i)));
  Py_DECREF(r);
  *out_dim = static_cast<mx_uint>(n);
  *out_pdata = st->shape_buf.data();
  return 0;
}

int MXNDArrayGetDType(NDArrayHandle handle, int *out_dtype) {
  Gil gil;
  auto *st = static_cast<MXNDState *>(handle);
  long v = call_long(PyObject_CallMethod(shim(), "nd_get_dtype", "l",
                                         st->shim_handle));
  if (v < 0) return -1;
  *out_dtype = static_cast<int>(v);
  return 0;
}

int MXNDArraySave(const char *fname, mx_uint num_args,
                  NDArrayHandle *args, const char **keys) {
  Gil gil;
  PyObject *hs = PyList_New(num_args);
  PyObject *ks = keys ? PyList_New(num_args) : Py_None;
  for (mx_uint i = 0; i < num_args; ++i) {
    PyList_SetItem(hs, i, PyLong_FromLong(
        static_cast<MXNDState *>(args[i])->shim_handle));
    if (keys)
      PyList_SetItem(ks, i, PyUnicode_FromString(keys[i]));
  }
  PyObject *r = PyObject_CallMethod(shim(), "nd_save", "sOO", fname, hs,
                                    ks);
  Py_DECREF(hs);
  if (keys) Py_DECREF(ks);
  if (!r) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int MXNDArrayLoad(const char *fname, mx_uint *out_size,
                  NDArrayHandle **out_arr, mx_uint *out_name_size,
                  const char ***out_names) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject *r = PyObject_CallMethod(shim(), "nd_load", "s", fname);
  if (!r) {
    capture_py_error();
    return -1;
  }
  PyObject *hs = PyTuple_GetItem(r, 0);
  PyObject *ns = PyTuple_GetItem(r, 1);
  static thread_local std::vector<NDArrayHandle> arr_store;
  static thread_local std::vector<std::string> name_store;
  static thread_local std::vector<const char *> name_ptrs;
  arr_store.clear();
  name_store.clear();
  name_ptrs.clear();
  for (Py_ssize_t i = 0; i < PyTuple_Size(hs); ++i) {
    auto *nd = new MXNDState();
    nd->shim_handle = PyLong_AsLong(PyTuple_GetItem(hs, i));
    arr_store.push_back(nd);
  }
  for (Py_ssize_t i = 0; i < PyTuple_Size(ns); ++i)
    name_store.emplace_back(PyUnicode_AsUTF8(PyTuple_GetItem(ns, i)));
  for (auto &s : name_store) name_ptrs.push_back(s.c_str());
  Py_DECREF(r);
  *out_size = static_cast<mx_uint>(arr_store.size());
  *out_arr = arr_store.data();
  *out_name_size = static_cast<mx_uint>(name_store.size());
  *out_names = name_ptrs.data();
  return 0;
}

int MXSymbolSaveToFile(SymbolHandle handle, const char *fname) {
  Gil gil;
  auto *st = static_cast<MXSymState *>(handle);
  PyObject *r = PyObject_CallMethod(shim(), "sym_save_to_file", "ls",
                                    st->shim_handle, fname);
  if (!r) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int MXSymbolCreateFromFile(const char *fname, SymbolHandle *out) {
  if (!ensure_python()) return -1;
  Gil gil;
  long h = call_long(
      PyObject_CallMethod(shim(), "sym_create_from_file", "s", fname));
  if (h < 0) return -1;
  auto *st = new MXSymState();
  st->shim_handle = h;
  *out = st;
  return 0;
}

int MXSymbolFree(SymbolHandle handle) {
  Gil gil;
  auto *st = static_cast<MXSymState *>(handle);
  PyObject *r = PyObject_CallMethod(shim(), "free", "l", st->shim_handle);
  Py_XDECREF(r);
  delete st;
  return r ? 0 : (capture_py_error(), -1);
}

// list_arguments via a CSV into a caller buffer would diverge from the
// reference; instead expose the count + per-index name (both shim-side
// tuples are cheap) so hosts can build arg tables.
int MXSymbolListArguments(SymbolHandle handle, mx_uint *out_size,
                          const char ***out_str_array) {
  Gil gil;
  auto *st = static_cast<MXSymState *>(handle);
  PyObject *r = PyObject_CallMethod(shim(), "sym_list_arguments", "l",
                                    st->shim_handle);
  if (!r) {
    capture_py_error();
    return -1;
  }
  static thread_local std::vector<std::string> name_store;
  static thread_local std::vector<const char *> ptr_store;
  Py_ssize_t n = PyTuple_Size(r);
  name_store.clear();
  ptr_store.clear();
  for (Py_ssize_t i = 0; i < n; ++i)
    name_store.emplace_back(PyUnicode_AsUTF8(PyTuple_GetItem(r, i)));
  for (auto &s : name_store) ptr_store.push_back(s.c_str());
  Py_DECREF(r);
  *out_size = static_cast<mx_uint>(n);
  *out_str_array = ptr_store.data();
  return 0;
}

int MXSymbolInferShape(
    SymbolHandle handle, mx_uint num_args, const char **keys,
    const mx_uint *arg_ind_ptr, const mx_uint *arg_shape_data,
    mx_uint *in_shape_size, const mx_uint **in_shape_ndim,
    const mx_uint ***in_shape_data, mx_uint *out_shape_size,
    const mx_uint **out_shape_ndim, const mx_uint ***out_shape_data,
    mx_uint *aux_shape_size, const mx_uint **aux_shape_ndim,
    const mx_uint ***aux_shape_data, int *complete) {
  Gil gil;
  auto *st = static_cast<MXSymState *>(handle);
  PyObject *k = PyList_New(num_args);
  PyObject *ip = PyList_New(num_args + 1);
  for (mx_uint i = 0; i < num_args; ++i)
    PyList_SetItem(k, i, PyUnicode_FromString(keys[i]));
  for (mx_uint i = 0; i <= num_args; ++i)
    PyList_SetItem(ip, i, PyLong_FromUnsignedLong(arg_ind_ptr[i]));
  mx_uint nd = arg_ind_ptr[num_args];
  PyObject *sd = PyList_New(nd);
  for (mx_uint i = 0; i < nd; ++i)
    PyList_SetItem(sd, i, PyLong_FromUnsignedLong(arg_shape_data[i]));
  PyObject *r = PyObject_CallMethod(shim(), "sym_infer_shape", "lOOO",
                                    st->shim_handle, k, ip, sd);
  Py_DECREF(k);
  Py_DECREF(ip);
  Py_DECREF(sd);
  if (!r) {
    capture_py_error();
    return -1;
  }
  st->shapes.clear();
  bool all_known = true;  // hosts branch on *complete (reference ABI)
  mx_uint *sizes[3] = {in_shape_size, out_shape_size, aux_shape_size};
  const mx_uint **ndims_out[3] = {in_shape_ndim, out_shape_ndim,
                                  aux_shape_ndim};
  const mx_uint ***datas_out[3] = {in_shape_data, out_shape_data,
                                   aux_shape_data};
  for (int g = 0; g < 3; ++g) {
    PyObject *grp = PyTuple_GetItem(r, g);
    Py_ssize_t n = PyTuple_Size(grp);
    st->ndims[g].clear();
    st->datas[g].clear();
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject *shp = PyTuple_GetItem(grp, i);
      Py_ssize_t m = PyTuple_Size(shp);
      st->shapes.emplace_back();
      auto &vec = st->shapes.back();
      for (Py_ssize_t j = 0; j < m; ++j) {
        mx_uint dim = static_cast<mx_uint>(
            PyLong_AsUnsignedLong(PyTuple_GetItem(shp, j)));
        if (dim == 0) all_known = false;  // 0 = unknown after partial infer
        vec.push_back(dim);
      }
      st->ndims[g].push_back(static_cast<mx_uint>(m));
    }
  }
  // second pass for data pointers: st->shapes no longer reallocates
  size_t idx = 0;
  for (int g = 0; g < 3; ++g) {
    for (size_t i = 0; i < st->ndims[g].size(); ++i)
      st->datas[g].push_back(st->shapes[idx++].data());
    *sizes[g] = static_cast<mx_uint>(st->ndims[g].size());
    *ndims_out[g] = st->ndims[g].data();
    *datas_out[g] = st->datas[g].data();
  }
  Py_DECREF(r);
  *complete = all_known ? 1 : 0;
  return 0;
}

int MXExecutorBind(SymbolHandle symbol_handle, int dev_type, int dev_id,
                   mx_uint len, NDArrayHandle *in_args,
                   NDArrayHandle *arg_grad_store, mx_uint *grad_req_type,
                   mx_uint aux_states_len, NDArrayHandle *aux_states,
                   ExecutorHandle *out) {
  (void)aux_states_len; (void)aux_states;
  Gil gil;
  auto *sym = static_cast<MXSymState *>(symbol_handle);
  PyObject *args = PyList_New(len);
  PyObject *grads = PyList_New(len);
  PyObject *reqs = PyList_New(len);
  for (mx_uint i = 0; i < len; ++i) {
    PyList_SetItem(args, i, PyLong_FromLong(
        static_cast<MXNDState *>(in_args[i])->shim_handle));
    PyList_SetItem(grads, i, PyLong_FromLong(
        arg_grad_store && arg_grad_store[i]
            ? static_cast<MXNDState *>(arg_grad_store[i])->shim_handle
            : 0));
    PyList_SetItem(reqs, i, PyLong_FromUnsignedLong(
        grad_req_type ? grad_req_type[i] : 0));
  }
  long h = call_long(PyObject_CallMethod(
      shim(), "executor_bind", "lOOOii", sym->shim_handle, args, grads,
      reqs, dev_type, dev_id));
  Py_DECREF(args);
  Py_DECREF(grads);
  Py_DECREF(reqs);
  if (h < 0) return -1;
  auto *st = new MXExecState();
  st->shim_handle = h;
  *out = st;
  return 0;
}

int MXExecutorForward(ExecutorHandle handle, int is_train) {
  Gil gil;
  auto *st = static_cast<MXExecState *>(handle);
  PyObject *r = PyObject_CallMethod(shim(), "executor_forward", "li",
                                    st->shim_handle, is_train);
  if (!r) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int MXExecutorBackward(ExecutorHandle handle, mx_uint len,
                       NDArrayHandle *head_grads) {
  (void)len; (void)head_grads;  // mean-loss heads: default ones
  Gil gil;
  auto *st = static_cast<MXExecState *>(handle);
  PyObject *r = PyObject_CallMethod(shim(), "executor_backward", "l",
                                    st->shim_handle);
  if (!r) {
    capture_py_error();
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

int MXExecutorOutputs(ExecutorHandle handle, mx_uint *out_size,
                      NDArrayHandle **out) {
  Gil gil;
  auto *st = static_cast<MXExecState *>(handle);
  long n = call_long(PyObject_CallMethod(shim(), "executor_num_outputs",
                                         "l", st->shim_handle));
  if (n < 0) return -1;
  static thread_local std::vector<NDArrayHandle> out_store;
  out_store.clear();
  for (long i = 0; i < n; ++i) {
    long h = call_long(PyObject_CallMethod(
        shim(), "executor_output", "ll", st->shim_handle, i));
    if (h < 0) {
      // release the handles already wrapped: the caller never sees them
      for (NDArrayHandle created : out_store) {
        auto *nd = static_cast<MXNDState *>(created);
        PyObject *fr = PyObject_CallMethod(shim(), "free", "l",
                                           nd->shim_handle);
        Py_XDECREF(fr);
        delete nd;
      }
      out_store.clear();
      return -1;
    }
    auto *nd = new MXNDState();
    nd->shim_handle = h;
    out_store.push_back(nd);
  }
  *out_size = static_cast<mx_uint>(n);
  *out = out_store.data();
  return 0;
}

int MXExecutorFree(ExecutorHandle handle) {
  Gil gil;
  auto *st = static_cast<MXExecState *>(handle);
  PyObject *r = PyObject_CallMethod(shim(), "free", "l", st->shim_handle);
  Py_XDECREF(r);
  delete st;
  return r ? 0 : (capture_py_error(), -1);
}

}  // extern "C"

// ========================================================================
// Imperative op invocation (MXNet's src/c_api/c_api_ndarray.cc:
// MXImperativeInvoke[Ex] and op discovery, the per-op path every
// language binding sits on).  Op handles are interned name strings;
// attributes cross as strings and parse in the shim.
// ========================================================================

typedef void *OpHandle;
typedef void *AtomicSymbolCreator;

extern "C" {

int MXListAllOpNames(mx_uint *out_size, const char ***out_array) {
  if (!ensure_python()) return -1;
  Gil gil;
  // valid until the next call on THIS thread (the file-wide ret-store
  // convention)
  static thread_local std::vector<std::string> name_store;
  static thread_local std::vector<const char *> ptr_store;
  PyObject *r = PyObject_CallMethod(shim(), "op_list_names", nullptr);
  if (!r) {
    capture_py_error();
    return -1;
  }
  Py_ssize_t n = PyTuple_Size(r);
  name_store.clear();
  ptr_store.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char *s = PyUnicode_AsUTF8(PyTuple_GetItem(r, i));
    name_store.emplace_back(s ? s : "");
  }
  Py_DECREF(r);
  for (auto &s : name_store) ptr_store.push_back(s.c_str());
  *out_size = static_cast<mx_uint>(n);
  *out_array = ptr_store.data();
  return 0;
}

// Name -> op handle (nnvm ABI anchor NNGetOpHandle).  Validates against
// the registry so hosts fail at lookup, not mid-invoke.
int NNGetOpHandle(const char *name, OpHandle *out) {
  if (!ensure_python()) return -1;
  Gil gil;
  PyObject *r = PyObject_CallMethod(shim(), "op_exists", "s", name);
  long ok = call_long(r);
  if (ok < 0) return -1;
  if (!ok) {
    set_error(std::string("unknown operator: ") + name);
    return -1;
  }
  static std::mutex mu;
  static std::map<std::string, std::unique_ptr<std::string>> interned;
  std::lock_guard<std::mutex> lk(mu);
  auto it = interned.find(name);
  if (it == interned.end())
    it = interned.emplace(name,
                          std::unique_ptr<std::string>(
                              new std::string(name))).first;
  *out = const_cast<char *>(it->second->c_str());
  return 0;
}

// creator = an OpHandle from NNGetOpHandle.  On entry *num_outputs may
// carry caller-supplied output handles (in-place update semantics, e.g.
// sgd_update with out=weight); 0 means the op allocates.  Allocated
// output handles are owned by the caller (MXNDArrayFree); the *outputs
// pointer array itself stays valid until the next invoke on this thread
// (reference thread-local ret-store semantics).
int MXImperativeInvoke(AtomicSymbolCreator creator, int num_inputs,
                       NDArrayHandle *inputs, int *num_outputs,
                       NDArrayHandle **outputs, int num_params,
                       const char **param_keys, const char **param_vals) {
  if (!ensure_python()) return -1;
  Gil gil;
  const char *name = static_cast<const char *>(creator);
  PyObject *ins = PyList_New(num_inputs);
  for (int i = 0; i < num_inputs; ++i)
    PyList_SetItem(ins, i, PyLong_FromLong(
        static_cast<MXNDState *>(inputs[i])->shim_handle));
  int n_out_in = *num_outputs;
  PyObject *outs_in = PyList_New(n_out_in);
  for (int i = 0; i < n_out_in; ++i)
    PyList_SetItem(outs_in, i, PyLong_FromLong(
        static_cast<MXNDState *>((*outputs)[i])->shim_handle));
  PyObject *keys = PyList_New(num_params);
  PyObject *vals = PyList_New(num_params);
  for (int i = 0; i < num_params; ++i) {
    PyList_SetItem(keys, i, PyUnicode_FromString(param_keys[i]));
    PyList_SetItem(vals, i, PyUnicode_FromString(param_vals[i]));
  }
  PyObject *r = PyObject_CallMethod(shim(), "imperative_invoke", "sOOOO",
                                    name, ins, outs_in, keys, vals);
  Py_DECREF(ins);
  Py_DECREF(outs_in);
  Py_DECREF(keys);
  Py_DECREF(vals);
  if (!r) {
    capture_py_error();
    return -1;
  }
  if (n_out_in > 0) {
    // caller-supplied handles were rebound in place; nothing to return
    *num_outputs = n_out_in;
    Py_DECREF(r);
    return 0;
  }
  Py_ssize_t n = PyTuple_Size(r);
  static thread_local std::vector<NDArrayHandle> out_store;
  out_store.clear();
  for (Py_ssize_t i = 0; i < n; ++i) {
    auto *nd = new MXNDState();
    nd->shim_handle = PyLong_AsLong(PyTuple_GetItem(r, i));
    out_store.push_back(nd);
  }
  Py_DECREF(r);
  *num_outputs = static_cast<int>(n);
  *outputs = out_store.data();
  return 0;
}

// Ex variant (reference MXImperativeInvokeEx): adds output storage-type
// reporting — dense-only here (kDefaultStorage = 0), matching the
// registry's dense ndarray handles.
int MXImperativeInvokeEx(AtomicSymbolCreator creator, int num_inputs,
                         NDArrayHandle *inputs, int *num_outputs,
                         NDArrayHandle **outputs, int num_params,
                         const char **param_keys, const char **param_vals,
                         const int **out_stypes) {
  int rc = MXImperativeInvoke(creator, num_inputs, inputs, num_outputs,
                              outputs, num_params, param_keys, param_vals);
  if (rc != 0) return rc;
  static thread_local std::vector<int> stype_store;
  stype_store.assign(static_cast<size_t>(*num_outputs), 0);
  *out_stypes = stype_store.data();
  return 0;
}

}  // extern "C"
