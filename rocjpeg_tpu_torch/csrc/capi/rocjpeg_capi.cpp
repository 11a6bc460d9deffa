// librocjpeg_tpu_torch.so — the C ABI of the PyTorch/CUDA port.
//
// Implements the nine rocJPEG entry points (reference api/rocjpeg.h:204-343,
// dispatch logic of src/rocjpeg_api.cpp) by embedding a CPython interpreter
// and forwarding to rocjpeg_tpu_torch.capi, where the decode pipeline (host
// parse and entropy pack, then the CUDA kernels) lives. The C layer owns:
// interpreter bootstrap, GIL discipline, handle lifetime, argument
// marshalling, and exception->status containment; it does no decoding.
//
// Threading: every entry point takes the GIL via PyGILState_Ensure, so the
// library is safe to call from any thread. The native host library and the
// kernel launches are reached through ctypes, which releases the GIL, so
// multi-threaded callers (the jpegDecodePerf model, one handle per thread)
// still overlap one thread's host work with another's device work.
//
// Linking: the library leaves the Python C API unresolved. In a Python
// process (ctypes) the running interpreter provides it; a C program links
// libpython itself (-lpython3.X), so one process never holds two copies.
// rocjpeg_tpu_torch.runtime.build.build_capi() compiles it, and both
// samples, from these sources at first use.
//
// Environment: the embedded interpreter imports rocjpeg_tpu_torch from
// ROCJPEG_TPU_ROOT or PYTHONPATH (which must also reach torch and numpy);
// ROCJPEG_TPU_TORCH_DEVICE=cpu puts every session on the host.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>

#include "include/rocjpeg_tpu.h"

namespace {

PyObject *g_capi = nullptr;  // rocjpeg_tpu_torch.capi module (owned)
RocJpegStatus g_init_status = ROCJPEG_STATUS_NOT_INITIALIZED;
std::once_flag g_init_once;

// A handle is a pinned reference to the Python-side session object plus a
// C-lifetime buffer for rocJpegGetLastError return values.
struct Handle {
    PyObject *obj;
    std::string err;
};

void InitializeRuntime() {
    const bool owned_init = !Py_IsInitialized();
    if (owned_init) {
        Py_InitializeEx(0);  // no signal handlers: we are a library
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    // Make the framework importable from arbitrary host processes:
    // honor ROCJPEG_TPU_ROOT in addition to PYTHONPATH.
    PyRun_SimpleString(
        "import os, sys\n"
        "_p = os.environ.get('ROCJPEG_TPU_ROOT')\n"
        "if _p and _p not in sys.path:\n"
        "    sys.path.insert(0, _p)\n");
    g_capi = PyImport_ImportModule("rocjpeg_tpu_torch.capi");
    if (g_capi == nullptr) {
        PyErr_Print();
        g_init_status = ROCJPEG_STATUS_NOT_INITIALIZED;
    } else {
        g_init_status = ROCJPEG_STATUS_SUCCESS;
    }
    PyGILState_Release(gil);
    if (owned_init) {
        // Drop the GIL acquired by Py_InitializeEx so other threads can
        // PyGILState_Ensure. The interpreter stays alive for the process
        // lifetime (no Py_Finalize: torch and its CUDA state do not
        // survive one).
        PyEval_SaveThread();
    }
}

RocJpegStatus EnsureRuntime() {
    std::call_once(g_init_once, InitializeRuntime);
    return g_init_status;
}

// Extract `status` (and optionally a new object reference at index 1) from a
// `(status, obj)` return. Steals nothing; returns a new ref in *out_obj.
RocJpegStatus StatusFromPair(PyObject *result, PyObject **out_obj) {
    if (result == nullptr) {
        PyErr_Print();
        return ROCJPEG_STATUS_RUNTIME_ERROR;
    }
    RocJpegStatus st = ROCJPEG_STATUS_RUNTIME_ERROR;
    if (PyTuple_Check(result) && PyTuple_GET_SIZE(result) >= 1) {
        st = static_cast<RocJpegStatus>(
            PyLong_AsLong(PyTuple_GET_ITEM(result, 0)));
        if (out_obj != nullptr && PyTuple_GET_SIZE(result) >= 2) {
            *out_obj = PyTuple_GET_ITEM(result, 1);
            Py_XINCREF(*out_obj);
        }
    } else if (PyLong_Check(result)) {
        st = static_cast<RocJpegStatus>(PyLong_AsLong(result));
    }
    Py_DECREF(result);
    return st;
}

// Build the per-image (channels, pitches) argument pair from a RocJpegImage:
// channel pointers as Python ints (0 for null), pitches as ints.
PyObject *ImageToTuples(const RocJpegImage *img) {
    PyObject *chans = PyTuple_New(ROCJPEG_MAX_COMPONENT);
    PyObject *pitches = PyTuple_New(ROCJPEG_MAX_COMPONENT);
    if (chans == nullptr || pitches == nullptr) {
        Py_XDECREF(chans);
        Py_XDECREF(pitches);
        return nullptr;
    }
    for (int i = 0; i < ROCJPEG_MAX_COMPONENT; ++i) {
        PyTuple_SET_ITEM(chans, i, PyLong_FromUnsignedLongLong(
            reinterpret_cast<unsigned long long>(img->channel[i])));
        PyTuple_SET_ITEM(pitches, i,
                         PyLong_FromUnsignedLong(img->pitch[i]));
    }
    PyObject *pair = PyTuple_Pack(2, chans, pitches);
    Py_DECREF(chans);
    Py_DECREF(pitches);
    return pair;
}

}  // namespace

extern "C" {

RocJpegStatus rocJpegStreamCreate(RocJpegStreamHandle *jpeg_stream_handle) {
    if (jpeg_stream_handle == nullptr) return ROCJPEG_STATUS_INVALID_PARAMETER;
    RocJpegStatus init = EnsureRuntime();
    if (init != ROCJPEG_STATUS_SUCCESS) return init;
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject *obj = nullptr;
    PyObject *r = PyObject_CallMethod(g_capi, "stream_create", nullptr);
    RocJpegStatus st = StatusFromPair(r, &obj);
    PyGILState_Release(gil);
    if (st == ROCJPEG_STATUS_SUCCESS && obj != nullptr) {
        *jpeg_stream_handle = new Handle{obj, {}};
    } else {
        Py_XDECREF(obj);
    }
    return st;
}

RocJpegStatus rocJpegStreamParse(const unsigned char *data, size_t length,
                                 RocJpegStreamHandle jpeg_stream_handle) {
    if (data == nullptr || jpeg_stream_handle == nullptr || length == 0) {
        return ROCJPEG_STATUS_INVALID_PARAMETER;
    }
    RocJpegStatus init = EnsureRuntime();
    if (init != ROCJPEG_STATUS_SUCCESS) return init;
    Handle *h = static_cast<Handle *>(jpeg_stream_handle);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(
        g_capi, "stream_parse", "Oy#", h->obj,
        reinterpret_cast<const char *>(data),
        static_cast<Py_ssize_t>(length));
    RocJpegStatus st = StatusFromPair(r, nullptr);
    PyGILState_Release(gil);
    return st;
}

RocJpegStatus rocJpegStreamDestroy(RocJpegStreamHandle jpeg_stream_handle) {
    if (jpeg_stream_handle == nullptr) return ROCJPEG_STATUS_INVALID_PARAMETER;
    Handle *h = static_cast<Handle *>(jpeg_stream_handle);
    PyGILState_STATE gil = PyGILState_Ensure();
    Py_XDECREF(h->obj);
    PyGILState_Release(gil);
    delete h;
    return ROCJPEG_STATUS_SUCCESS;
}

RocJpegStatus rocJpegCreate(RocJpegBackend backend, int device_id,
                            RocJpegHandle *handle) {
    if (handle == nullptr) return ROCJPEG_STATUS_INVALID_PARAMETER;
    RocJpegStatus init = EnsureRuntime();
    if (init != ROCJPEG_STATUS_SUCCESS) return init;
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject *obj = nullptr;
    PyObject *r = PyObject_CallMethod(g_capi, "create", "ii",
                                      static_cast<int>(backend), device_id);
    RocJpegStatus st = StatusFromPair(r, &obj);
    PyGILState_Release(gil);
    if (st == ROCJPEG_STATUS_SUCCESS && obj != nullptr) {
        *handle = new Handle{obj, {}};
    } else {
        Py_XDECREF(obj);
    }
    return st;
}

RocJpegStatus rocJpegDestroy(RocJpegHandle handle) {
    if (handle == nullptr) return ROCJPEG_STATUS_INVALID_PARAMETER;
    Handle *h = static_cast<Handle *>(handle);
    PyGILState_STATE gil = PyGILState_Ensure();
    Py_XDECREF(h->obj);
    PyGILState_Release(gil);
    delete h;
    return ROCJPEG_STATUS_SUCCESS;
}

RocJpegStatus rocJpegGetImageInfo(RocJpegHandle handle,
                                  RocJpegStreamHandle jpeg_stream_handle,
                                  uint8_t *num_components,
                                  RocJpegChromaSubsampling *subsampling,
                                  uint32_t *widths, uint32_t *heights) {
    if (handle == nullptr || jpeg_stream_handle == nullptr ||
        num_components == nullptr || subsampling == nullptr ||
        widths == nullptr || heights == nullptr) {
        return ROCJPEG_STATUS_INVALID_PARAMETER;
    }
    Handle *h = static_cast<Handle *>(handle);
    Handle *s = static_cast<Handle *>(jpeg_stream_handle);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(g_capi, "get_image_info", "OO",
                                      h->obj, s->obj);
    RocJpegStatus st = ROCJPEG_STATUS_RUNTIME_ERROR;
    if (r != nullptr) {
        int st_i = 0, nc = 0, css = -1;
        unsigned int w[4] = {0, 0, 0, 0}, ht[4] = {0, 0, 0, 0};
        if (PyArg_ParseTuple(r, "iii(IIII)(IIII)", &st_i, &nc, &css,
                             &w[0], &w[1], &w[2], &w[3],
                             &ht[0], &ht[1], &ht[2], &ht[3])) {
            st = static_cast<RocJpegStatus>(st_i);
            *num_components = static_cast<uint8_t>(nc);
            *subsampling = static_cast<RocJpegChromaSubsampling>(css);
            for (int i = 0; i < 4; ++i) {
                widths[i] = w[i];
                heights[i] = ht[i];
            }
        } else {
            PyErr_Print();
        }
        Py_DECREF(r);
    } else {
        PyErr_Print();
    }
    PyGILState_Release(gil);
    return st;
}

RocJpegStatus rocJpegDecodeBatched(RocJpegHandle handle,
                                   RocJpegStreamHandle *jpeg_stream_handles,
                                   int batch_size,
                                   const RocJpegDecodeParams *decode_params,
                                   RocJpegImage *destinations) {
    if (handle == nullptr || jpeg_stream_handles == nullptr ||
        batch_size < 1 || decode_params == nullptr ||
        destinations == nullptr) {
        return ROCJPEG_STATUS_INVALID_PARAMETER;
    }
    Handle *h = static_cast<Handle *>(handle);
    PyGILState_STATE gil = PyGILState_Ensure();
    RocJpegStatus st = ROCJPEG_STATUS_RUNTIME_ERROR;
    PyObject *streams = PyList_New(batch_size);
    PyObject *chans = PyList_New(batch_size);
    PyObject *pitches = PyList_New(batch_size);
    bool ok = streams != nullptr && chans != nullptr && pitches != nullptr;
    for (int i = 0; ok && i < batch_size; ++i) {
        Handle *s = static_cast<Handle *>(jpeg_stream_handles[i]);
        if (s == nullptr) {
            ok = false;
            st = ROCJPEG_STATUS_INVALID_PARAMETER;
            break;
        }
        Py_INCREF(s->obj);
        PyList_SET_ITEM(streams, i, s->obj);
        PyObject *pair = ImageToTuples(&destinations[i]);
        if (pair == nullptr) {
            ok = false;
            break;
        }
        PyObject *c = PyTuple_GET_ITEM(pair, 0);
        PyObject *p = PyTuple_GET_ITEM(pair, 1);
        Py_INCREF(c);
        Py_INCREF(p);
        PyList_SET_ITEM(chans, i, c);
        PyList_SET_ITEM(pitches, i, p);
        Py_DECREF(pair);
    }
    if (ok) {
        const auto &cr = decode_params->crop_rectangle;
        PyObject *r = PyObject_CallMethod(
            g_capi, "decode_batched", "OOi(iiii)OO", h->obj, streams,
            static_cast<int>(decode_params->output_format),
            static_cast<int>(cr.left), static_cast<int>(cr.top),
            static_cast<int>(cr.right), static_cast<int>(cr.bottom),
            chans, pitches);
        st = StatusFromPair(r, nullptr);
    }
    Py_XDECREF(streams);
    Py_XDECREF(chans);
    Py_XDECREF(pitches);
    PyGILState_Release(gil);
    return st;
}

RocJpegStatus rocJpegDecode(RocJpegHandle handle,
                            RocJpegStreamHandle jpeg_stream_handle,
                            const RocJpegDecodeParams *decode_params,
                            RocJpegImage *destination) {
    return rocJpegDecodeBatched(handle, &jpeg_stream_handle, 1, decode_params,
                                destination);
}

const char *rocJpegGetErrorName(RocJpegStatus rocjpeg_status) {
    // Static strings so this works before runtime init and never allocates
    // (same contract as src/rocjpeg_api.cpp:246-277).
    switch (rocjpeg_status) {
        case ROCJPEG_STATUS_SUCCESS: return "ROCJPEG_STATUS_SUCCESS";
        case ROCJPEG_STATUS_NOT_INITIALIZED: return "ROCJPEG_STATUS_NOT_INITIALIZED";
        case ROCJPEG_STATUS_INVALID_PARAMETER: return "ROCJPEG_STATUS_INVALID_PARAMETER";
        case ROCJPEG_STATUS_BAD_JPEG: return "ROCJPEG_STATUS_BAD_JPEG";
        case ROCJPEG_STATUS_JPEG_NOT_SUPPORTED: return "ROCJPEG_STATUS_JPEG_NOT_SUPPORTED";
        case ROCJPEG_STATUS_OUTOF_MEMORY: return "ROCJPEG_STATUS_OUTOF_MEMORY";
        case ROCJPEG_STATUS_EXECUTION_FAILED: return "ROCJPEG_STATUS_EXECUTION_FAILED";
        case ROCJPEG_STATUS_ARCH_MISMATCH: return "ROCJPEG_STATUS_ARCH_MISMATCH";
        case ROCJPEG_STATUS_INTERNAL_ERROR: return "ROCJPEG_STATUS_INTERNAL_ERROR";
        case ROCJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED:
            return "ROCJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED";
        case ROCJPEG_STATUS_HW_JPEG_DECODER_NOT_SUPPORTED:
            return "ROCJPEG_STATUS_HW_JPEG_DECODER_NOT_SUPPORTED";
        case ROCJPEG_STATUS_RUNTIME_ERROR: return "ROCJPEG_STATUS_RUNTIME_ERROR";
        case ROCJPEG_STATUS_NOT_IMPLEMENTED: return "ROCJPEG_STATUS_NOT_IMPLEMENTED";
        default: return "UNKNOWN_ROCJPEG_STATUS";
    }
}

const char *rocJpegGetLastError(RocJpegHandle handle) {
    if (handle == nullptr || g_capi == nullptr) return "";
    Handle *h = static_cast<Handle *>(handle);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(g_capi, "get_last_error", "O", h->obj);
    if (r != nullptr && PyUnicode_Check(r)) {
        const char *msg = PyUnicode_AsUTF8(r);
        h->err = msg != nullptr ? msg : "";
    } else {
        PyErr_Clear();
    }
    Py_XDECREF(r);
    PyGILState_Release(gil);
    return h->err.c_str();
}

}  // extern "C"
