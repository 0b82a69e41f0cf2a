// whisper.h-shaped C ABI over the whisper_tpu_torch Python engine (the
// PyTorch/CUDA port; native/whisper_abi.cpp with the edits that
// tests/test_torch_copies.py lists).
//
// The reference's public contract is a C API over opaque contexts
// (include/whisper.h:201-767) consumed by four language bindings
// (bindings/go, java, ruby, javascript).  whisper_tpu's engine is Python
// (JAX), so this shim embeds CPython and forwards the whisper.h call
// sequence to whisper_tpu_torch.capi — letting a C/FFI host drive the TPU engine
// with the familiar init/full/get-segment calls.  whisper_full takes the
// whisper.h-layout whisper_full_params struct by value, five C callbacks
// included (trampolined through ctypes onto the Python callbacks — see the
// struct section at the bottom of this file); *_json variants take the
// same params as a JSON string for FFIs that cannot marshal C structs.
// Functions not meaningful off-device (ggml backend introspection) are
// not exported.
//
// Build (whisper_tpu_torch/abi.py does it at first use):
//   g++ -shared -fPIC whisper_tpu_torch/native/whisper_abi.cpp \
//       -o whisper_tpu_torch/build/libwhisper_tpu_torch.so \
//       $(python3-config --includes) -L$(python3-config --prefix)/lib \
//       -lpython3.X -Wl,-rpath,$(python3-config --prefix)/lib
//
// Thread-safety: every entry point takes the GIL (PyGILState_Ensure), so
// the shim may be called from any host thread, matching the reference's
// per-context external-synchronization contract.

#include <Python.h>

#include <cfloat>
#include <cstdarg>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

PyObject * g_capi = nullptr;   // whisper_tpu_torch.capi module
std::once_flag g_init_once;
bool g_owns_interpreter = false;

void ensure_runtime() {
    std::call_once(g_init_once, [] {
        if (!Py_IsInitialized()) {
            Py_InitializeEx(0);
            g_owns_interpreter = true;
        }
        PyGILState_STATE gil = PyGILState_Ensure();
        g_capi = PyImport_ImportModule("whisper_tpu_torch.capi");
        if (!g_capi) {
            PyErr_Print();
        }
        if (g_owns_interpreter) {
            // release the GIL acquired implicitly by Py_InitializeEx so
            // later PyGILState_Ensure calls work from any thread
            PyGILState_Release(gil);
            PyEval_SaveThread();
        } else {
            PyGILState_Release(gil);
        }
    });
}

// call capi.<name>(args...) and return the result (new ref), or null
PyObject * call(const char * name, PyObject * args) {
    if (!g_capi) {
        Py_XDECREF(args);
        return nullptr;
    }
    PyObject * fn = PyObject_GetAttrString(g_capi, name);
    if (!fn) {
        Py_XDECREF(args);
        PyErr_Print();
        return nullptr;
    }
    PyObject * res = PyObject_CallObject(fn, args);
    Py_DECREF(fn);
    Py_XDECREF(args);
    if (!res) {
        PyErr_Print();
    }
    return res;
}

long call_long(const char * name, long fallback,
               const char * fmt, ...) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * args = nullptr;
    if (fmt) {
        va_list ap;
        va_start(ap, fmt);
        args = Py_VaBuildValue(fmt, ap);
        va_end(ap);
    }
    PyObject * res = call(name, args);
    long out = fallback;
    if (res && res != Py_None) {
        out = PyLong_AsLong(res);
        if (PyErr_Occurred()) {
            PyErr_Clear();
            out = fallback;
        }
    }
    Py_XDECREF(res);
    PyGILState_Release(gil);
    return out;
}

double call_double(const char * name, double fallback,
                   const char * fmt, ...) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * args = nullptr;
    if (fmt) {
        va_list ap;
        va_start(ap, fmt);
        args = Py_VaBuildValue(fmt, ap);
        va_end(ap);
    }
    PyObject * res = call(name, args);
    double out = fallback;
    if (res && res != Py_None) {
        out = PyFloat_AsDouble(res);
        if (PyErr_Occurred()) {
            PyErr_Clear();
            out = fallback;
        }
    }
    Py_XDECREF(res);
    PyGILState_Release(gil);
    return out;
}

// per-thread scratch for returned C strings (stable until the next
// string-returning call on the same thread, like the reference's internal
// buffers)
thread_local std::string g_str_scratch;

// wrap a C float buffer as a numpy f32 view (borrowed memory; only valid
// for the duration of the call it is passed to)
PyObject * np_f32_view(const float * data, Py_ssize_t n) {
    PyObject * mem = PyMemoryView_FromMemory(
        (char *) data, n * 4, PyBUF_READ);
    if (!mem) return nullptr;
    PyObject * np_mod = PyImport_ImportModule("numpy");
    PyObject * arr = nullptr;
    if (np_mod) {
        arr = PyObject_CallMethod(np_mod, "frombuffer", "Os", mem, "<f4");
        Py_DECREF(np_mod);
    }
    Py_DECREF(mem);
    return arr;
}

// call a capi function returning bytes; copy into out (up to cap bytes);
// returns bytes copied or -1
long call_bytes_out(const char * name, char * out, long cap,
                    const char * fmt, ...) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * args = nullptr;
    if (fmt) {
        va_list ap;
        va_start(ap, fmt);
        args = Py_VaBuildValue(fmt, ap);
        va_end(ap);
    }
    PyObject * res = call(name, args);
    long n = -1;
    if (res && PyBytes_Check(res)) {
        n = (long) PyBytes_GET_SIZE(res);
        if (n > cap) n = cap;
        memcpy(out, PyBytes_AS_STRING(res), (size_t) n);
    }
    Py_XDECREF(res);
    PyGILState_Release(gil);
    return n;
}

const char * call_str(const char * name, const char * fmt, ...) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * args = nullptr;
    if (fmt) {
        va_list ap;
        va_start(ap, fmt);
        args = Py_VaBuildValue(fmt, ap);
        va_end(ap);
    }
    PyObject * res = call(name, args);
    g_str_scratch.clear();
    if (res) {
        if (const char * s = PyUnicode_AsUTF8(res)) {
            g_str_scratch = s;
        } else {
            PyErr_Clear();
        }
        Py_DECREF(res);
    }
    PyGILState_Release(gil);
    return g_str_scratch.c_str();
}

}  // namespace

extern "C" {

struct whisper_context;  // opaque; the pointer value IS the python handle

struct whisper_context * whisper_init_from_file(const char * path) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * res = call("init_from_file", Py_BuildValue("(s)", path));
    intptr_t h = 0;
    if (res) {
        h = (intptr_t) PyLong_AsLong(res);
        Py_DECREF(res);
    }
    PyGILState_Release(gil);
    return (struct whisper_context *) h;  // 0 -> NULL, like the reference
}

void whisper_free(struct whisper_context * ctx) {
    if (!ctx) return;
    call_long("free", 0, "(l)", (long) (intptr_t) ctx);
}

// params_json: JSON object of whisper_full_params field names (or NULL for
// defaults); samples: 16 kHz mono f32 PCM.  The struct-taking whisper_full
// (whisper.h:640) is defined at the bottom of this file.
int whisper_full_json(struct whisper_context * ctx, const char * params_json,
                      const float * samples, int n_samples) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * mem = PyMemoryView_FromMemory(
        (char *) samples, (Py_ssize_t) n_samples * 4, PyBUF_READ);
    PyObject * np_mod = PyImport_ImportModule("numpy");
    PyObject * arr = nullptr;
    if (np_mod && mem) {
        arr = PyObject_CallMethod(np_mod, "frombuffer", "Os", mem, "<f4");
    }
    int rc = -1;
    if (arr) {
        PyObject * res = call(
            "full", Py_BuildValue("(l, s, O)", (long) (intptr_t) ctx,
                                  params_json, arr));
        if (res) {
            rc = (int) PyLong_AsLong(res);
            Py_DECREF(res);
        }
    }
    Py_XDECREF(arr);
    Py_XDECREF(np_mod);
    Py_XDECREF(mem);
    PyGILState_Release(gil);
    return rc;
}

// whisper_full_parallel (whisper.h:621): chunk-split data parallelism
int whisper_full_parallel_json(struct whisper_context * ctx,
                               const char * params_json,
                               const float * samples, int n_samples,
                               int n_processors) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * mem = PyMemoryView_FromMemory(
        (char *) samples, (Py_ssize_t) n_samples * 4, PyBUF_READ);
    PyObject * np_mod = PyImport_ImportModule("numpy");
    PyObject * arr = nullptr;
    if (np_mod && mem) {
        arr = PyObject_CallMethod(np_mod, "frombuffer", "Os", mem, "<f4");
    }
    int rc = -1;
    if (arr) {
        PyObject * res = call(
            "full_parallel",
            Py_BuildValue("(l, s, O, i)", (long) (intptr_t) ctx,
                          params_json, arr, n_processors));
        if (res) {
            rc = (int) PyLong_AsLong(res);
            Py_DECREF(res);
        }
    }
    Py_XDECREF(arr);
    Py_XDECREF(np_mod);
    Py_XDECREF(mem);
    PyGILState_Release(gil);
    return rc;
}

int whisper_full_n_segments(struct whisper_context * ctx) {
    return (int) call_long("full_n_segments", 0, "(l)",
                           (long) (intptr_t) ctx);
}

int64_t whisper_full_get_segment_t0(struct whisper_context * ctx, int i) {
    return call_long("full_get_segment_t0", 0, "(l,i)",
                     (long) (intptr_t) ctx, i);
}

int64_t whisper_full_get_segment_t1(struct whisper_context * ctx, int i) {
    return call_long("full_get_segment_t1", 0, "(l,i)",
                     (long) (intptr_t) ctx, i);
}

const char * whisper_full_get_segment_text(struct whisper_context * ctx,
                                           int i) {
    return call_str("full_get_segment_text", "(l,i)",
                    (long) (intptr_t) ctx, i);
}

int whisper_full_n_tokens(struct whisper_context * ctx, int i) {
    return (int) call_long("full_n_tokens", 0, "(l,i)",
                           (long) (intptr_t) ctx, i);
}

int whisper_full_get_token_id(struct whisper_context * ctx, int i, int j) {
    return (int) call_long("full_get_token_id", -1, "(l,i,i)",
                           (long) (intptr_t) ctx, i, j);
}

int whisper_lang_max_id(void) {
    return (int) call_long("lang_max_id", -1, nullptr);
}

int whisper_lang_id(const char * lang) {
    return (int) call_long("lang_id", -1, "(s)", lang);
}

const char * whisper_lang_str(int id) {
    return call_str("lang_str", "(i)", id);
}

const char * whisper_print_system_info(void) {
    return call_str("system_info", nullptr);
}

void whisper_print_timings(struct whisper_context * ctx) {
    call_long("print_timings", 0, "(l)", (long) (intptr_t) ctx);
}

void whisper_reset_timings(struct whisper_context * ctx) {
    call_long("reset_timings", 0, "(l)", (long) (intptr_t) ctx);
}

const char * whisper_version(void) {
    return call_str("version", nullptr);
}

// ---- init variants (whisper.h:216) ------------------------------------

struct whisper_context * whisper_init_from_buffer(void * buffer,
                                                  size_t buffer_size) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * res = call("init_from_buffer",
                          Py_BuildValue("(y#)", (char *) buffer,
                                        (Py_ssize_t) buffer_size));
    intptr_t h = 0;
    if (res) {
        h = (intptr_t) PyLong_AsLong(res);
        Py_DECREF(res);
    }
    PyGILState_Release(gil);
    return (struct whisper_context *) h;
}

// ---- decode states (whisper.h:214, 650) --------------------------------

struct whisper_state;  // opaque; the pointer value IS the python handle

struct whisper_state * whisper_init_state(struct whisper_context * ctx) {
    return (struct whisper_state *) (intptr_t) call_long(
        "init_state", 0, "(l)", (long) (intptr_t) ctx);
}

void whisper_free_state(struct whisper_state * state) {
    if (!state) return;
    call_long("free_state", 0, "(l)", (long) (intptr_t) state);
}

int whisper_full_with_state_json(struct whisper_context * ctx,
                                 struct whisper_state * state,
                                 const char * params_json,
                                 const float * samples, int n_samples) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * arr = np_f32_view(samples, (Py_ssize_t) n_samples);
    int rc = -1;
    if (arr) {
        PyObject * res = call(
            "full_with_state",
            Py_BuildValue("(l, l, s, O)", (long) (intptr_t) ctx,
                          (long) (intptr_t) state, params_json, arr));
        if (res) {
            rc = (int) PyLong_AsLong(res);
            Py_DECREF(res);
        }
        Py_DECREF(arr);
    }
    PyGILState_Release(gil);
    return rc;
}

int whisper_full_n_segments_from_state(struct whisper_state * state) {
    return (int) call_long("full_n_segments_from_state", 0, "(l)",
                           (long) (intptr_t) state);
}

int64_t whisper_full_get_segment_t0_from_state(struct whisper_state * state,
                                               int i) {
    return call_long("full_get_segment_t0_from_state", 0, "(l,i)",
                     (long) (intptr_t) state, i);
}

int64_t whisper_full_get_segment_t1_from_state(struct whisper_state * state,
                                               int i) {
    return call_long("full_get_segment_t1_from_state", 0, "(l,i)",
                     (long) (intptr_t) state, i);
}

const char * whisper_full_get_segment_text_from_state(
        struct whisper_state * state, int i) {
    return call_str("full_get_segment_text_from_state", "(l,i)",
                    (long) (intptr_t) state, i);
}

bool whisper_full_get_segment_speaker_turn_next_from_state(
        struct whisper_state * state, int i) {
    return call_long("full_get_segment_speaker_turn_next_from_state", 0,
                     "(l,i)", (long) (intptr_t) state, i) != 0;
}

float whisper_full_get_segment_no_speech_prob_from_state(
        struct whisper_state * state, int i) {
    return (float) call_double(
        "full_get_segment_no_speech_prob_from_state", 0.0, "(l,i)",
        (long) (intptr_t) state, i);
}

int whisper_full_n_tokens_from_state(struct whisper_state * state, int i) {
    return (int) call_long("full_n_tokens_from_state", 0, "(l,i)",
                           (long) (intptr_t) state, i);
}

int whisper_full_get_token_id_from_state(struct whisper_state * state,
                                         int i, int j) {
    return (int) call_long("full_get_token_id_from_state", -1, "(l,i,i)",
                           (long) (intptr_t) state, i, j);
}

float whisper_full_get_token_p_from_state(struct whisper_state * state,
                                          int i, int j) {
    return (float) call_double("full_get_token_p_from_state", 0.0,
                               "(l,i,i)", (long) (intptr_t) state, i, j);
}

int whisper_full_lang_id_from_state(struct whisper_state * state) {
    return (int) call_long("full_lang_id_from_state", -1, "(l)",
                           (long) (intptr_t) state);
}

// ---- segment/token accessors (whisper.h:700-745) ------------------------

bool whisper_full_get_segment_speaker_turn_next(struct whisper_context * ctx,
                                                int i) {
    return call_long("full_get_segment_speaker_turn_next", 0, "(l,i)",
                     (long) (intptr_t) ctx, i) != 0;
}

float whisper_full_get_segment_no_speech_prob(struct whisper_context * ctx,
                                              int i) {
    return (float) call_double("full_get_segment_no_speech_prob", 0.0,
                               "(l,i)", (long) (intptr_t) ctx, i);
}

float whisper_full_get_token_p(struct whisper_context * ctx, int i, int j) {
    return (float) call_double("full_get_token_p", 0.0, "(l,i,i)",
                               (long) (intptr_t) ctx, i, j);
}

const char * whisper_full_get_token_text(struct whisper_context * ctx,
                                         int i, int j) {
    return call_str("full_get_token_text", "(l,i,i)",
                    (long) (intptr_t) ctx, i, j);
}

int64_t whisper_full_get_token_t0(struct whisper_context * ctx,
                                  int i, int j) {
    return call_long("full_get_token_t0", -1, "(l,i,i)",
                     (long) (intptr_t) ctx, i, j);
}

int64_t whisper_full_get_token_t1(struct whisper_context * ctx,
                                  int i, int j) {
    return call_long("full_get_token_t1", -1, "(l,i,i)",
                     (long) (intptr_t) ctx, i, j);
}

// whisper_full_get_token_data (whisper.h:733): the whisper_token_data
// struct crosses as JSON, like params
const char * whisper_full_get_token_data_json(struct whisper_context * ctx,
                                              int i, int j) {
    return call_str("full_get_token_data_json", "(l,i,i)",
                    (long) (intptr_t) ctx, i, j);
}

int whisper_full_lang_id(struct whisper_context * ctx) {
    return (int) call_long("full_lang_id", -1, "(l)",
                           (long) (intptr_t) ctx);
}

// ---- model / vocab introspection (whisper.h:270-330) --------------------

#define WTPU_INT_ACCESSOR(NAME)                                          \
    int whisper_##NAME(struct whisper_context * ctx) {                   \
        return (int) call_long(#NAME, -1, "(l)", (long) (intptr_t) ctx); \
    }

WTPU_INT_ACCESSOR(n_len)
WTPU_INT_ACCESSOR(n_vocab)
WTPU_INT_ACCESSOR(n_text_ctx)
WTPU_INT_ACCESSOR(n_audio_ctx)
WTPU_INT_ACCESSOR(is_multilingual)
WTPU_INT_ACCESSOR(model_n_vocab)
WTPU_INT_ACCESSOR(model_n_audio_ctx)
WTPU_INT_ACCESSOR(model_n_audio_state)
WTPU_INT_ACCESSOR(model_n_audio_head)
WTPU_INT_ACCESSOR(model_n_audio_layer)
WTPU_INT_ACCESSOR(model_n_text_ctx)
WTPU_INT_ACCESSOR(model_n_text_state)
WTPU_INT_ACCESSOR(model_n_text_head)
WTPU_INT_ACCESSOR(model_n_text_layer)
WTPU_INT_ACCESSOR(model_n_mels)
WTPU_INT_ACCESSOR(model_ftype)
WTPU_INT_ACCESSOR(model_type)
WTPU_INT_ACCESSOR(token_eot)
WTPU_INT_ACCESSOR(token_sot)
WTPU_INT_ACCESSOR(token_solm)
WTPU_INT_ACCESSOR(token_prev)
WTPU_INT_ACCESSOR(token_nosp)
WTPU_INT_ACCESSOR(token_not)
WTPU_INT_ACCESSOR(token_beg)
WTPU_INT_ACCESSOR(token_translate)
WTPU_INT_ACCESSOR(token_transcribe)

#undef WTPU_INT_ACCESSOR

const char * whisper_model_type_readable(struct whisper_context * ctx) {
    return call_str("model_type_readable", "(l)", (long) (intptr_t) ctx);
}

int whisper_token_lang(struct whisper_context * ctx, int lang_id) {
    return (int) call_long("token_lang", -1, "(l,i)",
                           (long) (intptr_t) ctx, lang_id);
}

const char * whisper_token_to_str(struct whisper_context * ctx, int token) {
    return call_str("token_to_str", "(l,i)", (long) (intptr_t) ctx, token);
}

// whisper_tokenize (whisper.h:357): fills tokens (<= n_max_tokens);
// returns the count, or -(count) if the text needed more room
int whisper_tokenize(struct whisper_context * ctx, const char * text,
                     int * tokens, int n_max_tokens) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * res = call("tokenize",
                          Py_BuildValue("(l,s)", (long) (intptr_t) ctx,
                                        text));
    int n = -1;
    if (res && PyList_Check(res)) {
        n = (int) PyList_GET_SIZE(res);
        if (n > n_max_tokens) {
            n = -n;  // like the reference: negative count on overflow
        } else {
            for (int k = 0; k < n; k++) {
                tokens[k] = (int) PyLong_AsLong(PyList_GET_ITEM(res, k));
            }
        }
    }
    Py_XDECREF(res);
    PyGILState_Release(gil);
    return n;
}

int whisper_token_count(struct whisper_context * ctx, const char * text) {
    return (int) call_long("token_count", -1, "(l,s)",
                           (long) (intptr_t) ctx, text);
}

// ---- low-level compute (whisper.h:262-345) -------------------------------

int whisper_pcm_to_mel(struct whisper_context * ctx, const float * samples,
                       int n_samples, int n_threads) {
    (void) n_threads;  // XLA owns threading
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * arr = np_f32_view(samples, (Py_ssize_t) n_samples);
    int rc = -1;
    if (arr) {
        PyObject * res = call("pcm_to_mel",
                              Py_BuildValue("(l,O)", (long) (intptr_t) ctx,
                                            arr));
        if (res) {
            rc = (int) PyLong_AsLong(res);
            Py_DECREF(res);
        }
        Py_DECREF(arr);
    }
    PyGILState_Release(gil);
    return rc;
}

int whisper_set_mel(struct whisper_context * ctx, const float * data,
                    int n_len, int n_mel) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * arr = np_f32_view(data, (Py_ssize_t) n_len * n_mel);
    int rc = -1;
    if (arr) {
        PyObject * res = call("set_mel",
                              Py_BuildValue("(l,O,i,i)",
                                            (long) (intptr_t) ctx, arr,
                                            n_len, n_mel));
        if (res) {
            rc = (int) PyLong_AsLong(res);
            Py_DECREF(res);
        }
        Py_DECREF(arr);
    }
    PyGILState_Release(gil);
    return rc;
}

int whisper_encode(struct whisper_context * ctx, int offset, int n_threads) {
    (void) n_threads;
    return (int) call_long("encode", -1, "(l,i)",
                           (long) (intptr_t) ctx, offset);
}

int whisper_decode(struct whisper_context * ctx, const int * tokens,
                   int n_tokens, int n_past, int n_threads) {
    (void) n_threads;
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * lst = PyList_New(n_tokens);
    for (int k = 0; k < n_tokens; k++) {
        PyList_SET_ITEM(lst, k, PyLong_FromLong(tokens[k]));
    }
    PyObject * res = call("decode",
                          Py_BuildValue("(l,O,i)", (long) (intptr_t) ctx,
                                        lst, n_past));
    Py_DECREF(lst);
    int rc = -1;
    if (res) {
        rc = (int) PyLong_AsLong(res);
        Py_DECREF(res);
    }
    PyGILState_Release(gil);
    return rc;
}

// logits of the final position of the last whisper_decode (n_vocab floats;
// buffer owned per context, valid until the next whisper_decode/free)
const float * whisper_get_logits(struct whisper_context * ctx) {
    static std::mutex mu;
    static std::map<long, std::vector<float>> bufs;
    long h = (long) (intptr_t) ctx;
    long nv = call_long("n_vocab", 0, "(l)", h);
    std::lock_guard<std::mutex> lock(mu);
    std::vector<float> & buf = bufs[h];
    buf.resize((size_t) (nv > 0 ? nv : 0));
    if (nv > 0) {
        call_bytes_out("get_logits_bytes", (char *) buf.data(), nv * 4,
                       "(l)", h);
    }
    return buf.data();
}

int whisper_lang_auto_detect(struct whisper_context * ctx,
                             int offset_ms, int n_threads,
                             float * lang_probs) {
    (void) n_threads;
    int lid = (int) call_long("lang_auto_detect", -1, "(l,i)",
                              (long) (intptr_t) ctx, offset_ms);
    if (lid >= 0 && lang_probs) {
        long n = call_long("lang_max_id", -1, nullptr) + 1;
        call_bytes_out("get_lang_probs_bytes", (char *) lang_probs, n * 4,
                       "(l)", (long) (intptr_t) ctx);
    }
    return lid;
}

// whisper_full_default_params_by_ref (whisper.h:587): defaults as JSON —
// edit fields and pass the string to whisper_full
const char * whisper_full_default_params_json(int strategy) {
    return call_str("full_default_params_json", "(i)", strategy);
}

// ---- VAD (whisper.h:699-756) --------------------------------------------

struct whisper_vad_context;  // opaque python handle

struct whisper_vad_context * whisper_vad_init_from_file(const char * path) {
    return (struct whisper_vad_context *) (intptr_t) call_long(
        "vad_init_from_file", 0, "(s)", path);
}

void whisper_vad_free(struct whisper_vad_context * vctx) {
    if (!vctx) return;
    call_long("vad_free", 0, "(l)", (long) (intptr_t) vctx);
}

// detect + segment in one call; returns an allocated segments handle freed
// by whisper_vad_free_segments (reference shape, whisper.h:739-750)
struct whisper_vad_segments;

struct whisper_vad_segments * whisper_vad_segments_from_samples_json(
        struct whisper_vad_context * vctx, const char * params_json,
        const float * samples, int n_samples) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * arr = np_f32_view(samples, (Py_ssize_t) n_samples);
    intptr_t h = 0;
    if (arr) {
        PyObject * res = call(
            "vad_segments_from_samples",
            Py_BuildValue("(l,s,O)", (long) (intptr_t) vctx, params_json,
                          arr));
        if (res) {
            h = (intptr_t) PyLong_AsLong(res);
            Py_DECREF(res);
        }
        Py_DECREF(arr);
    }
    PyGILState_Release(gil);
    return (struct whisper_vad_segments *) h;
}

int whisper_vad_segments_n_segments(struct whisper_vad_segments * segments) {
    return (int) call_long("vad_segments_n_segments", 0, "(l)",
                           (long) (intptr_t) segments);
}

float whisper_vad_segments_get_segment_t0(
        struct whisper_vad_segments * segments, int i) {
    return (float) call_double("vad_segments_get_segment_t0", -1.0, "(l,i)",
                               (long) (intptr_t) segments, i);
}

float whisper_vad_segments_get_segment_t1(
        struct whisper_vad_segments * segments, int i) {
    return (float) call_double("vad_segments_get_segment_t1", -1.0, "(l,i)",
                               (long) (intptr_t) segments, i);
}

void whisper_vad_free_segments(struct whisper_vad_segments * segments) {
    if (!segments) return;
    call_long("vad_free_segments", 0, "(l)", (long) (intptr_t) segments);
}

}  // extern "C"

// ---- built-in microbenchmarks (whisper.h:756-759) -------------------------

extern "C" {

const char * whisper_bench_memcpy_str(int n_threads) {
    (void) n_threads;  // the TPU runtime picks its own parallelism
    return call_str("bench_memcpy_str", nullptr);
}

int whisper_bench_memcpy(int n_threads) {
    const char * s = whisper_bench_memcpy_str(n_threads);
    if (s) fprintf(stderr, "%s", s);
    return 0;
}

const char * whisper_bench_ggml_mul_mat_str(int n_threads) {
    (void) n_threads;
    return call_str("bench_ggml_mul_mat_str", nullptr);
}

int whisper_bench_ggml_mul_mat(int n_threads) {
    const char * s = whisper_bench_ggml_mul_mat_str(n_threads);
    if (s) fprintf(stderr, "%s", s);
    return 0;
}

}  // extern "C"

// ---- state-variant step-by-step API (whisper.h:265-341, 417) --------------
// states are cloned contexts Python-side; each forwards with the state
// handle (the ctx argument is kept for whisper.h signature parity)

extern "C" {

int whisper_pcm_to_mel_with_state(struct whisper_context * ctx,
                                  struct whisper_state * state,
                                  const float * samples, int n_samples,
                                  int n_threads) {
    (void) ctx; (void) n_threads;
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * arr = np_f32_view(samples, (Py_ssize_t) n_samples);
    int rc = -1;
    if (arr) {
        PyObject * res = call("pcm_to_mel",
                              Py_BuildValue("(l,O)",
                                            (long) (intptr_t) state, arr));
        if (res) { rc = (int) PyLong_AsLong(res); Py_DECREF(res); }
        Py_DECREF(arr);
    }
    PyGILState_Release(gil);
    return rc;
}

int whisper_set_mel_with_state(struct whisper_context * ctx,
                               struct whisper_state * state,
                               const float * data, int n_len, int n_mel) {
    (void) ctx;
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * arr = np_f32_view(data, (Py_ssize_t) n_len * n_mel);
    int rc = -1;
    if (arr) {
        PyObject * res = call("set_mel",
                              Py_BuildValue("(l,O,i,i)",
                                            (long) (intptr_t) state, arr,
                                            n_len, n_mel));
        if (res) { rc = (int) PyLong_AsLong(res); Py_DECREF(res); }
        Py_DECREF(arr);
    }
    PyGILState_Release(gil);
    return rc;
}

int whisper_encode_with_state(struct whisper_context * ctx,
                              struct whisper_state * state,
                              int offset, int n_threads) {
    (void) ctx; (void) n_threads;
    return (int) call_long("encode", -1, "(l,i)",
                           (long) (intptr_t) state, offset);
}

int whisper_decode_with_state(struct whisper_context * ctx,
                              struct whisper_state * state,
                              const int * tokens, int n_tokens,
                              int n_past, int n_threads) {
    (void) ctx; (void) n_threads;
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * lst = PyList_New(n_tokens);
    for (int k = 0; k < n_tokens; k++) {
        PyList_SET_ITEM(lst, k, PyLong_FromLong(tokens[k]));
    }
    PyObject * res = call("decode",
                          Py_BuildValue("(l,O,i)",
                                        (long) (intptr_t) state, lst,
                                        n_past));
    Py_DECREF(lst);
    int rc = -1;
    if (res) { rc = (int) PyLong_AsLong(res); Py_DECREF(res); }
    PyGILState_Release(gil);
    return rc;
}

const float * whisper_get_logits_from_state(struct whisper_state * state) {
    static std::mutex mu;
    static std::map<long, std::vector<float>> bufs;
    long h = (long) (intptr_t) state;
    long nv = call_long("n_vocab", 0, "(l)", h);
    std::lock_guard<std::mutex> lock(mu);
    std::vector<float> & buf = bufs[h];
    buf.resize((size_t) (nv > 0 ? nv : 0));
    if (nv > 0) {
        call_bytes_out("get_logits_bytes", (char *) buf.data(), nv * 4,
                       "(l)", h);
    }
    return buf.data();
}

int whisper_n_len_from_state(struct whisper_state * state) {
    return (int) call_long("n_len_from_state", 0, "(l)",
                           (long) (intptr_t) state);
}

int whisper_lang_auto_detect_with_state(struct whisper_context * ctx,
                                        struct whisper_state * state,
                                        int offset_ms, int n_threads,
                                        float * lang_probs) {
    (void) ctx; (void) n_threads;
    int lid = (int) call_long("lang_auto_detect", -1, "(l,i)",
                              (long) (intptr_t) state, offset_ms);
    if (lid >= 0 && lang_probs) {
        long n = call_long("lang_max_id", -1, nullptr) + 1;
        call_bytes_out("get_lang_probs_bytes", (char *) lang_probs, n * 4,
                       "(l)", (long) (intptr_t) state);
    }
    return lid;
}

// ---- remaining from_state token accessors (whisper.h:730-745) -------------

const char * whisper_full_get_token_text_from_state(
        struct whisper_context * ctx, struct whisper_state * state,
        int i, int j) {
    return call_str("full_get_token_text_from_state", "(l,l,i,i)",
                    (long) (intptr_t) ctx, (long) (intptr_t) state, i, j);
}

int64_t whisper_full_get_token_t0_from_state(struct whisper_state * state,
                                             int i, int j) {
    return (int64_t) call_long("full_get_token_t0_from_state", -1,
                               "(l,i,i)", (long) (intptr_t) state, i, j);
}

int64_t whisper_full_get_token_t1_from_state(struct whisper_state * state,
                                             int i, int j) {
    return (int64_t) call_long("full_get_token_t1_from_state", -1,
                               "(l,i,i)", (long) (intptr_t) state, i, j);
}

const char * whisper_full_get_token_data_json_from_state(
        struct whisper_state * state, int i, int j) {
    return call_str("full_get_token_data_json_from_state", "(l,i,i)",
                    (long) (intptr_t) state, i, j);
}

// ---- VAD segments recorded by whisper_full (whisper.h:686-698) ------------

int whisper_full_n_vad_segments(struct whisper_context * ctx) {
    return (int) call_long("full_n_vad_segments", 0, "(l)",
                           (long) (intptr_t) ctx);
}

int64_t whisper_full_get_vad_segment_t0(struct whisper_context * ctx, int i) {
    return (int64_t) call_long("full_get_vad_segment_t0", -1, "(l,i)",
                               (long) (intptr_t) ctx, i);
}

int64_t whisper_full_get_vad_segment_t1(struct whisper_context * ctx, int i) {
    return (int64_t) call_long("full_get_vad_segment_t1", -1, "(l,i)",
                               (long) (intptr_t) ctx, i);
}

int whisper_full_n_vad_segments_from_state(struct whisper_state * state) {
    return (int) call_long("full_n_vad_segments_from_state", 0, "(l)",
                           (long) (intptr_t) state);
}

int64_t whisper_full_get_vad_segment_t0_from_state(
        struct whisper_state * state, int i) {
    return (int64_t) call_long("full_get_vad_segment_t0_from_state", -1,
                               "(l,i)", (long) (intptr_t) state, i);
}

int64_t whisper_full_get_vad_segment_t1_from_state(
        struct whisper_state * state, int i) {
    return (int64_t) call_long("full_get_vad_segment_t1_from_state", -1,
                               "(l,i)", (long) (intptr_t) state, i);
}

// ---- low-level VAD probability API (whisper.h:717-742) --------------------

struct whisper_vad_context;

bool whisper_vad_detect_speech(struct whisper_vad_context * vctx,
                               const float * samples, int n_samples) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * arr = np_f32_view(samples, (Py_ssize_t) n_samples);
    long ok = 0;
    if (arr) {
        PyObject * res = call("vad_detect_speech",
                              Py_BuildValue("(l,O,i)",
                                            (long) (intptr_t) vctx, arr, 1));
        if (res) { ok = PyLong_AsLong(res); Py_DECREF(res); }
        Py_DECREF(arr);
    }
    PyGILState_Release(gil);
    return ok == 1;
}

// streaming variant: the Silero LSTM h/c carries across calls
bool whisper_vad_detect_speech_no_reset(struct whisper_vad_context * vctx,
                                        const float * samples,
                                        int n_samples) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * arr = np_f32_view(samples, (Py_ssize_t) n_samples);
    long ok = 0;
    if (arr) {
        PyObject * res = call("vad_detect_speech",
                              Py_BuildValue("(l,O,i)",
                                            (long) (intptr_t) vctx, arr, 0));
        if (res) { ok = PyLong_AsLong(res); Py_DECREF(res); }
        Py_DECREF(arr);
    }
    PyGILState_Release(gil);
    return ok == 1;
}

int whisper_vad_n_probs(struct whisper_vad_context * vctx) {
    return (int) call_long("vad_n_probs", 0, "(l)", (long) (intptr_t) vctx);
}

// per-chunk speech probabilities of the last detect_speech (buffer owned
// per vad context, valid until the next detect_speech/free)
float * whisper_vad_probs(struct whisper_vad_context * vctx) {
    static std::mutex mu;
    static std::map<long, std::vector<float>> bufs;
    long h = (long) (intptr_t) vctx;
    long n = call_long("vad_n_probs", 0, "(l)", h);
    std::lock_guard<std::mutex> lock(mu);
    std::vector<float> & buf = bufs[h];
    buf.resize((size_t) (n > 0 ? n : 0));
    if (n > 0) {
        call_bytes_out("vad_probs_bytes", (char *) buf.data(), n * 4,
                       "(l)", h);
    }
    return buf.data();
}

void whisper_vad_reset_state(struct whisper_vad_context * vctx) {
    call_long("vad_reset_state", 0, "(l)", (long) (intptr_t) vctx);
}

// segment the probs from the last detect_speech; accessors shared with
// whisper_vad_segments_from_samples
struct whisper_vad_segments * whisper_vad_segments_from_probs_json(
        struct whisper_vad_context * vctx, const char * params_json) {
    return (struct whisper_vad_segments *) (intptr_t) call_long(
        "vad_segments_from_probs", 0, "(l,s)",
        (long) (intptr_t) vctx, params_json);
}

// ---- whisper_log_set (whisper.h:584) ---------------------------------------

typedef void (*whisper_log_callback)(int level, const char * text,
                                     void * user_data);

void whisper_log_set(whisper_log_callback callback, void * user_data) {
    ensure_runtime();
    call_long("log_set_c_sink", 0, "(l,l)",
              (long) (intptr_t) callback, (long) (intptr_t) user_data);
}

}  // extern "C"

// ---- whisper.h-compatible structs + remaining lifecycle -------------------
// mirrors include/whisper.h:86-159, 205-246, 370, 438-447; struct layouts
// must match native/whisper_tpu.h exactly

extern "C" {

enum whisper_alignment_heads_preset {
    WHISPER_AHEADS_NONE,
    WHISPER_AHEADS_N_TOP_MOST,
    WHISPER_AHEADS_CUSTOM,
    WHISPER_AHEADS_TINY_EN,
    WHISPER_AHEADS_TINY,
    WHISPER_AHEADS_BASE_EN,
    WHISPER_AHEADS_BASE,
    WHISPER_AHEADS_SMALL_EN,
    WHISPER_AHEADS_SMALL,
    WHISPER_AHEADS_MEDIUM_EN,
    WHISPER_AHEADS_MEDIUM,
    WHISPER_AHEADS_LARGE_V1,
    WHISPER_AHEADS_LARGE_V2,
    WHISPER_AHEADS_LARGE_V3,
    WHISPER_AHEADS_LARGE_V3_TURBO,
};

typedef struct whisper_ahead {
    int n_text_layer;
    int n_head;
} whisper_ahead;

typedef struct whisper_aheads {
    size_t n_heads;
    const whisper_ahead * heads;
} whisper_aheads;

struct whisper_context_params {
    bool  use_gpu;
    bool  flash_attn;
    int   gpu_device;
    bool dtw_token_timestamps;
    enum whisper_alignment_heads_preset dtw_aheads_preset;
    int dtw_n_top;
    struct whisper_aheads dtw_aheads;
    size_t dtw_mem_size;
};

typedef struct whisper_token_data {
    int32_t id;
    int32_t tid;
    float p;
    float plog;
    float pt;
    float ptsum;
    int64_t t0;
    int64_t t1;
    int64_t t_dtw;
    float vlen;
} whisper_token_data;

struct whisper_timings {
    float sample_ms;
    float encode_ms;
    float decode_ms;
    float batchd_ms;
    float prompt_ms;
};

typedef struct whisper_model_loader {
    void * context;
    size_t (*read)(void * ctx, void * output, size_t read_size);
    bool    (*eof)(void * ctx);
    void  (*close)(void * ctx);
} whisper_model_loader;

struct whisper_context_params whisper_context_default_params(void) {
    struct whisper_context_params p;
    memset(&p, 0, sizeof(p));
    p.use_gpu    = true;   // reference defaults (src/whisper.cpp:3700-3712)
    p.flash_attn = false;
    p.gpu_device = 0;
    p.dtw_token_timestamps = false;
    p.dtw_aheads_preset = WHISPER_AHEADS_NONE;
    p.dtw_n_top = -1;
    p.dtw_mem_size = (size_t) 1024 * 1024 * 128;
    return p;
}

struct whisper_context_params * whisper_context_default_params_by_ref(void) {
    struct whisper_context_params * p =
        (struct whisper_context_params *) malloc(sizeof(*p));
    if (p) *p = whisper_context_default_params();
    return p;
}

void whisper_free_context_params(struct whisper_context_params * params) {
    free(params);
}

void whisper_free_params(void * params) {
    free(params);
}

// cparams -> JSON for capi.init_from_file_with_cparams: use_gpu and
// gpu_device choose the device, then the DTW fields act
static std::string cparams_to_json(const struct whisper_context_params & p) {
    std::string js = "{";
    js += "\"use_gpu\": ";
    js += p.use_gpu ? "true" : "false";
    js += ", \"gpu_device\": " + std::to_string(p.gpu_device);
    js += ", \"dtw_token_timestamps\": ";
    js += p.dtw_token_timestamps ? "true" : "false";
    js += ", \"dtw_aheads_preset\": " + std::to_string((int) p.dtw_aheads_preset);
    js += ", \"dtw_n_top\": " + std::to_string(p.dtw_n_top);
    if (p.dtw_aheads_preset == WHISPER_AHEADS_CUSTOM && p.dtw_aheads.heads) {
        js += ", \"dtw_aheads\": [";
        for (size_t k = 0; k < p.dtw_aheads.n_heads; ++k) {
            if (k) js += ", ";
            js += "[" + std::to_string(p.dtw_aheads.heads[k].n_text_layer) +
                  ", " + std::to_string(p.dtw_aheads.heads[k].n_head) + "]";
        }
        js += "]";
    }
    js += "}";
    return js;
}

struct whisper_context * whisper_init_from_file_with_params(
        const char * path_model, struct whisper_context_params params) {
    const std::string js = cparams_to_json(params);
    return (struct whisper_context *) (intptr_t)
        call_long("init_from_file_with_cparams", 0, "(s,s)",
                  path_model, js.c_str());
}

struct whisper_context * whisper_init_from_buffer_with_params(
        void * buffer, size_t buffer_size,
        struct whisper_context_params params) {
    const std::string js = cparams_to_json(params);
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    // tuple built manually: Py_BuildValue's "y#" length-type depends on
    // PY_SSIZE_T_CLEAN-era headers — avoid the varargs pitfall entirely
    PyObject * args = PyTuple_New(2);
    PyTuple_SET_ITEM(args, 0, PyBytes_FromStringAndSize(
                                  (const char *) buffer,
                                  (Py_ssize_t) buffer_size));
    PyTuple_SET_ITEM(args, 1, PyUnicode_FromString(js.c_str()));
    PyObject * res = call("init_from_buffer_with_cparams", args);
    intptr_t h = 0;
    if (res) { h = (intptr_t) PyLong_AsLong(res); Py_DECREF(res); }
    PyGILState_Release(gil);
    return (struct whisper_context *) h;
}

// drain a whisper_model_loader into memory, then init from the buffer
struct whisper_context * whisper_init_with_params(
        struct whisper_model_loader * loader,
        struct whisper_context_params params) {
    if (!loader || !loader->read) return nullptr;
    std::vector<char> buf;
    char chunk[1 << 16];
    while (!(loader->eof && loader->eof(loader->context))) {
        size_t n = loader->read(loader->context, chunk, sizeof(chunk));
        if (n == 0) break;
        buf.insert(buf.end(), chunk, chunk + n);
    }
    if (loader->close) loader->close(loader->context);
    if (buf.empty()) return nullptr;
    return whisper_init_from_buffer_with_params(buf.data(), buf.size(),
                                                params);
}

// *_no_state: whisper_tpu contexts allocate no eager state (states come
// from whisper_init_state), so these are exact aliases
struct whisper_context * whisper_init_from_file_with_params_no_state(
        const char * path_model, struct whisper_context_params params) {
    return whisper_init_from_file_with_params(path_model, params);
}

struct whisper_context * whisper_init_from_buffer_with_params_no_state(
        void * buffer, size_t buffer_size,
        struct whisper_context_params params) {
    return whisper_init_from_buffer_with_params(buffer, buffer_size, params);
}

struct whisper_context * whisper_init_with_params_no_state(
        struct whisper_model_loader * loader,
        struct whisper_context_params params) {
    return whisper_init_with_params(loader, params);
}

struct whisper_context * whisper_init(struct whisper_model_loader * loader) {
    return whisper_init_with_params(loader, whisper_context_default_params());
}

struct whisper_context * whisper_init_no_state(
        struct whisper_model_loader * loader) {
    return whisper_init(loader);
}

struct whisper_context * whisper_init_from_file_no_state(
        const char * path_model) {
    return whisper_init_from_file(path_model);
}

struct whisper_context * whisper_init_from_buffer_no_state(void * buffer,
                                                           size_t buffer_size) {
    return whisper_init_from_buffer(buffer, buffer_size);
}

const char * whisper_lang_str_full(int id) {
    return call_str("lang_str_full", "(i)", id);
}

// per-context timings struct, valid until whisper_free/process exit
struct whisper_timings * whisper_get_timings(struct whisper_context * ctx) {
    static std::mutex mu;
    static std::map<long, struct whisper_timings> bufs;
    long h = (long) (intptr_t) ctx;
    float packed[5] = {0, 0, 0, 0, 0};
    call_bytes_out("get_timings_packed", (char *) packed, sizeof(packed),
                   "(l)", h);
    std::lock_guard<std::mutex> lock(mu);
    struct whisper_timings & t = bufs[h];
    t.sample_ms = packed[0];
    t.encode_ms = packed[1];
    t.decode_ms = packed[2];
    t.batchd_ms = packed[3];
    t.prompt_ms = packed[4];
    return &t;
}

// packed little-endian "<2i4f3qf" from capi -> struct fields
static whisper_token_data unpack_token_data(const char * b, long n) {
    whisper_token_data d;
    memset(&d, 0, sizeof(d));
    d.t0 = d.t1 = d.t_dtw = -1;
    if (n < 52) return d;
    memcpy(&d.id,    b +  0, 4);
    memcpy(&d.tid,   b +  4, 4);
    memcpy(&d.p,     b +  8, 4);
    memcpy(&d.plog,  b + 12, 4);
    memcpy(&d.pt,    b + 16, 4);
    memcpy(&d.ptsum, b + 20, 4);
    memcpy(&d.t0,    b + 24, 8);
    memcpy(&d.t1,    b + 32, 8);
    memcpy(&d.t_dtw, b + 40, 8);
    memcpy(&d.vlen,  b + 48, 4);
    return d;
}

whisper_token_data whisper_full_get_token_data(struct whisper_context * ctx,
                                               int i_segment, int i_token) {
    char buf[52];
    long n = call_bytes_out("full_get_token_data_packed", buf, sizeof(buf),
                            "(l,i,i)", (long) (intptr_t) ctx,
                            i_segment, i_token);
    return unpack_token_data(buf, n);
}

whisper_token_data whisper_full_get_token_data_from_state(
        struct whisper_state * state, int i_segment, int i_token) {
    char buf[52];
    long n = call_bytes_out("full_get_token_data_packed_from_state", buf,
                            sizeof(buf), "(l,i,i)",
                            (long) (intptr_t) state, i_segment, i_token);
    return unpack_token_data(buf, n);
}

}  // extern "C"

// ---- VAD param structs + init variants (whisper.h:192-199, 701-712) -------

extern "C" {

typedef struct whisper_vad_params {
    float threshold;
    int   min_speech_duration_ms;
    int   min_silence_duration_ms;
    float max_speech_duration_s;
    int   speech_pad_ms;
    float samples_overlap;
} whisper_vad_params;

struct whisper_vad_context_params {
    int   n_threads;
    bool  use_gpu;
    int   gpu_device;
};

whisper_vad_params whisper_vad_default_params(void) {
    whisper_vad_params p;           // src/whisper.cpp:4462-4472
    p.threshold               = 0.5f;
    p.min_speech_duration_ms  = 250;
    p.min_silence_duration_ms = 100;
    p.max_speech_duration_s   = FLT_MAX;
    p.speech_pad_ms           = 30;
    p.samples_overlap         = 0.1f;
    return p;
}

struct whisper_vad_context_params whisper_vad_default_context_params(void) {
    // src/whisper.cpp:4453-4460, but use_gpu true: the port's entry points
    // run on the card unless the host asks for the CPU
    struct whisper_vad_context_params p;
    p.n_threads  = 4;
    p.use_gpu    = true;
    p.gpu_device = 0;
    return p;
}

// use_gpu and gpu_device choose the VAD context's device (n_threads has
// no knob here)
static std::string vad_cparams_to_json(
        const struct whisper_vad_context_params & p) {
    std::string js = "{\"use_gpu\": ";
    js += p.use_gpu ? "true" : "false";
    js += ", \"gpu_device\": " + std::to_string(p.gpu_device) + "}";
    return js;
}

struct whisper_vad_context * whisper_vad_init_from_file_with_params(
        const char * path_model, struct whisper_vad_context_params params) {
    const std::string js = vad_cparams_to_json(params);
    return (struct whisper_vad_context *) (intptr_t) call_long(
        "vad_init_from_file_with_cparams", 0, "(s,s)", path_model, js.c_str());
}

struct whisper_vad_context * whisper_vad_init_with_params(
        struct whisper_model_loader * loader,
        struct whisper_vad_context_params params) {
    if (!loader || !loader->read) return nullptr;
    std::vector<char> buf;
    char chunk[1 << 16];
    while (!(loader->eof && loader->eof(loader->context))) {
        size_t n = loader->read(loader->context, chunk, sizeof(chunk));
        if (n == 0) break;
        buf.insert(buf.end(), chunk, chunk + n);
    }
    if (loader->close) loader->close(loader->context);
    if (buf.empty()) return nullptr;
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * args = PyTuple_New(2);
    PyTuple_SET_ITEM(args, 0, PyBytes_FromStringAndSize(buf.data(),
                                                        (Py_ssize_t) buf.size()));
    PyTuple_SET_ITEM(args, 1, PyUnicode_FromString(
                                  vad_cparams_to_json(params).c_str()));
    PyObject * res = call("vad_init_from_buffer_with_cparams", args);
    intptr_t h = 0;
    if (res) { h = (intptr_t) PyLong_AsLong(res); Py_DECREF(res); }
    PyGILState_Release(gil);
    return (struct whisper_vad_context *) h;
}

}  // extern "C"

// ---- whisper_full_params struct surface + the five C callbacks ------------
//
// Field-for-field whisper.h:455-591 layout (see native/whisper_tpu.h for the
// consumer declaration).  The struct is serialized to the JSON dialect
// _params_from_json speaks, and the five function pointers are passed to
// capi.full_struct as integer addresses; the Python side wraps them in
// ctypes trampolines onto TranscribeParams' callbacks, so the C host gets
// new_segment / progress / encoder_begin / abort / logits_filter calls
// mid-run, exactly like the reference (src/whisper.cpp:5945-6051 defaults,
// bindings/go/whisper.go:20-44 consumption pattern).

extern "C" {

typedef int32_t whisper_token;

enum whisper_sampling_strategy {
    WHISPER_SAMPLING_GREEDY,
    WHISPER_SAMPLING_BEAM_SEARCH,
};

enum whisper_gretype {
    WHISPER_GRETYPE_END            = 0,
    WHISPER_GRETYPE_ALT            = 1,
    WHISPER_GRETYPE_RULE_REF       = 2,
    WHISPER_GRETYPE_CHAR           = 3,
    WHISPER_GRETYPE_CHAR_NOT       = 4,
    WHISPER_GRETYPE_CHAR_RNG_UPPER = 5,
    WHISPER_GRETYPE_CHAR_ALT       = 6,
};

typedef struct whisper_grammar_element {
    enum whisper_gretype type;
    uint32_t             value;
} whisper_grammar_element;

struct whisper_state;

typedef void (*whisper_new_segment_callback)(
        struct whisper_context * ctx, struct whisper_state * state,
        int n_new, void * user_data);
typedef void (*whisper_progress_callback)(
        struct whisper_context * ctx, struct whisper_state * state,
        int progress, void * user_data);
typedef bool (*whisper_encoder_begin_callback)(
        struct whisper_context * ctx, struct whisper_state * state,
        void * user_data);
typedef bool (*ggml_abort_callback)(void * data);
typedef void (*whisper_logits_filter_callback)(
        struct whisper_context * ctx, struct whisper_state * state,
        const whisper_token_data * tokens, int n_tokens,
        float * logits, void * user_data);

struct whisper_full_params {
    enum whisper_sampling_strategy strategy;

    int n_threads;
    int n_max_text_ctx;
    int offset_ms;
    int duration_ms;

    bool translate;
    bool no_context;
    bool no_timestamps;
    bool single_segment;
    bool print_special;
    bool print_progress;
    bool print_realtime;
    bool print_timestamps;

    bool  token_timestamps;
    float thold_pt;
    float thold_ptsum;
    int   max_len;
    bool  split_on_word;
    int   max_tokens;

    bool debug_mode;
    int  audio_ctx;

    bool tdrz_enable;

    const char * suppress_regex;

    const char * initial_prompt;
    bool carry_initial_prompt;
    const whisper_token * prompt_tokens;
    int prompt_n_tokens;

    const char * language;
    bool detect_language;

    bool suppress_blank;
    bool suppress_nst;

    float temperature;
    float max_initial_ts;
    float length_penalty;

    float temperature_inc;
    float entropy_thold;
    float logprob_thold;
    float no_speech_thold;

    struct {
        int best_of;
    } greedy;

    struct {
        int   beam_size;
        float patience;
    } beam_search;

    whisper_new_segment_callback new_segment_callback;
    void * new_segment_callback_user_data;

    whisper_progress_callback progress_callback;
    void * progress_callback_user_data;

    whisper_encoder_begin_callback encoder_begin_callback;
    void * encoder_begin_callback_user_data;

    ggml_abort_callback abort_callback;
    void * abort_callback_user_data;

    whisper_logits_filter_callback logits_filter_callback;
    void * logits_filter_callback_user_data;

    const whisper_grammar_element ** grammar_rules;
    size_t                           n_grammar_rules;
    size_t                           i_start_rule;
    float                            grammar_penalty;

    bool         vad;
    const char * vad_model_path;
    whisper_vad_params vad_params;
};

}  // extern "C" (reopened below; helpers are C++)

namespace {

void json_escape_into(std::string & out, const char * s) {
    out += '"';
    for (const unsigned char * p = (const unsigned char *) s; *p; ++p) {
        switch (*p) {
            case '"':  out += "\\\""; break;
            case '\\': out += "\\\\"; break;
            case '\n': out += "\\n";  break;
            case '\r': out += "\\r";  break;
            case '\t': out += "\\t";  break;
            default:
                if (*p < 0x20) {
                    char buf[8];
                    snprintf(buf, sizeof(buf), "\\u%04x", (unsigned) *p);
                    out += buf;
                } else {
                    out += (char) *p;
                }
        }
    }
    out += '"';
}

void add_bool(std::string & out, const char * key, bool v) {
    out += '"'; out += key; out += "\":"; out += v ? "true" : "false";
    out += ',';
}

void add_int(std::string & out, const char * key, long long v) {
    out += '"'; out += key; out += "\":"; out += std::to_string(v);
    out += ',';
}

void add_float(std::string & out, const char * key, double v) {
    char buf[40];
    snprintf(buf, sizeof(buf), "%.9g", v);
    out += '"'; out += key; out += "\":"; out += buf; out += ',';
}

void add_str(std::string & out, const char * key, const char * v) {
    out += '"'; out += key; out += "\":";
    if (v) json_escape_into(out, v); else out += "null";
    out += ',';
}

extern "C" {  // the definition below sits in an extern "C" block; the
              // forward declaration must carry the same language linkage
static std::string vparams_to_json(whisper_vad_params p);
}

// serialize the struct into the JSON object _params_from_json speaks
std::string fparams_to_json(const struct whisper_full_params & p) {
    std::string out = "{";
    add_int(out, "strategy", (int) p.strategy);
    add_int(out, "n_threads", p.n_threads);
    add_int(out, "n_max_text_ctx", p.n_max_text_ctx);
    add_int(out, "offset_ms", p.offset_ms);
    add_int(out, "duration_ms", p.duration_ms);
    add_bool(out, "translate", p.translate);
    add_bool(out, "no_context", p.no_context);
    add_bool(out, "no_timestamps", p.no_timestamps);
    add_bool(out, "single_segment", p.single_segment);
    add_bool(out, "print_special", p.print_special);
    add_bool(out, "print_progress", p.print_progress);
    add_bool(out, "print_realtime", p.print_realtime);
    add_bool(out, "print_timestamps", p.print_timestamps);
    add_bool(out, "token_timestamps", p.token_timestamps);
    add_float(out, "thold_pt", p.thold_pt);
    add_float(out, "thold_ptsum", p.thold_ptsum);
    add_int(out, "max_len", p.max_len);
    add_bool(out, "split_on_word", p.split_on_word);
    add_int(out, "max_tokens", p.max_tokens);
    add_bool(out, "debug_mode", p.debug_mode);
    add_int(out, "audio_ctx", p.audio_ctx);
    add_bool(out, "tdrz_enable", p.tdrz_enable);
    if (p.suppress_regex && p.suppress_regex[0]) {
        add_str(out, "suppress_regex", p.suppress_regex);
    }
    if (p.initial_prompt) {
        add_str(out, "initial_prompt", p.initial_prompt);
    }
    add_bool(out, "carry_initial_prompt", p.carry_initial_prompt);
    if (p.prompt_tokens && p.prompt_n_tokens > 0) {
        out += "\"prompt_tokens\":[";
        for (int i = 0; i < p.prompt_n_tokens; ++i) {
            if (i) out += ',';
            out += std::to_string(p.prompt_tokens[i]);
        }
        out += "],";
    }
    add_str(out, "language", p.language);
    add_bool(out, "detect_language", p.detect_language);
    add_bool(out, "suppress_blank", p.suppress_blank);
    add_bool(out, "suppress_nst", p.suppress_nst);
    add_float(out, "temperature", p.temperature);
    add_float(out, "max_initial_ts", p.max_initial_ts);
    add_float(out, "length_penalty", p.length_penalty);
    add_float(out, "temperature_inc", p.temperature_inc);
    add_float(out, "entropy_thold", p.entropy_thold);
    add_float(out, "logprob_thold", p.logprob_thold);
    add_float(out, "no_speech_thold", p.no_speech_thold);
    add_int(out, "greedy.best_of", p.greedy.best_of);
    add_int(out, "beam_search.beam_size", p.beam_search.beam_size);
    add_float(out, "beam_search.patience", p.beam_search.patience);
    if (p.grammar_rules && p.n_grammar_rules > 0) {
        // each rule is a whisper_grammar_element array terminated by (and
        // including) its first WHISPER_GRETYPE_END, like the reference's
        // grammar-parser output
        out += "\"grammar_rules\":[";
        for (size_t r = 0; r < p.n_grammar_rules; ++r) {
            if (r) out += ',';
            out += '[';
            const whisper_grammar_element * e = p.grammar_rules[r];
            for (size_t k = 0;; ++k) {
                if (k) out += ',';
                out += '[';
                out += std::to_string((int) e[k].type);
                out += ',';
                out += std::to_string(e[k].value);
                out += ']';
                if (e[k].type == WHISPER_GRETYPE_END) break;
            }
            out += ']';
        }
        out += "],";
    }
    add_int(out, "i_start_rule", (long long) p.i_start_rule);
    add_float(out, "grammar_penalty", p.grammar_penalty);
    add_bool(out, "vad", p.vad);
    if (p.vad_model_path) {
        add_str(out, "vad_model_path", p.vad_model_path);
    }
    // one serializer for whisper_vad_params (also used by the VAD API
    // entry points) so the two paths cannot drift
    out += "\"vad_params\":" + vparams_to_json(p.vad_params);
    out += '}';
    return out;
}

// function-pointer addresses for capi._install_c_callbacks
std::string fcallbacks_to_json(const struct whisper_full_params & p) {
    std::string out = "{";
    add_int(out, "new_segment", (long long) (uintptr_t) p.new_segment_callback);
    add_int(out, "new_segment_ud", (long long) (uintptr_t) p.new_segment_callback_user_data);
    add_int(out, "progress", (long long) (uintptr_t) p.progress_callback);
    add_int(out, "progress_ud", (long long) (uintptr_t) p.progress_callback_user_data);
    add_int(out, "encoder_begin", (long long) (uintptr_t) p.encoder_begin_callback);
    add_int(out, "encoder_begin_ud", (long long) (uintptr_t) p.encoder_begin_callback_user_data);
    add_int(out, "abort", (long long) (uintptr_t) p.abort_callback);
    add_int(out, "abort_ud", (long long) (uintptr_t) p.abort_callback_user_data);
    add_int(out, "logits_filter", (long long) (uintptr_t) p.logits_filter_callback);
    add_int(out, "logits_filter_ud", (long long) (uintptr_t) p.logits_filter_callback_user_data);
    out.back() = '}';
    return out;
}

int full_struct_call(const char * pyfn, long h, long sh,
                     const struct whisper_full_params & params,
                     const float * samples, int n_samples,
                     int n_processors) {
    ensure_runtime();
    std::string pj = fparams_to_json(params);
    std::string cj = fcallbacks_to_json(params);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * arr = np_f32_view(samples, (Py_ssize_t) n_samples);
    int rc = -1;
    if (arr) {
        PyObject * args = n_processors > 0
            ? Py_BuildValue("(l,s,s,O,i)", h, pj.c_str(), cj.c_str(), arr,
                            n_processors)
            : Py_BuildValue("(l,l,s,s,O)", h, sh, pj.c_str(), cj.c_str(),
                            arr);
        PyObject * res = call(pyfn, args);
        if (res) {
            rc = (int) PyLong_AsLong(res);
            Py_DECREF(res);
        }
        Py_DECREF(arr);
    }
    PyGILState_Release(gil);
    return rc;
}

}  // namespace

extern "C" {

// reference defaults, src/whisper.cpp:5945-6051 (n_threads pinned to 4:
// XLA owns threading, the field is accepted but ignored)
struct whisper_full_params whisper_full_default_params(
        enum whisper_sampling_strategy strategy) {
    struct whisper_full_params p;
    memset(&p, 0, sizeof(p));
    p.strategy         = strategy;
    p.n_threads        = 4;
    p.n_max_text_ctx   = 16384;
    p.no_context       = true;
    p.print_progress   = true;
    p.print_timestamps = true;
    p.thold_pt         = 0.01f;
    p.thold_ptsum      = 0.01f;
    p.language         = "en";
    p.suppress_blank   = true;
    p.max_initial_ts   = 1.0f;
    p.length_penalty   = -1.0f;
    p.temperature_inc  = 0.2f;
    p.entropy_thold    = 2.4f;
    p.logprob_thold    = -1.0f;
    p.no_speech_thold  = 0.6f;
    p.greedy.best_of          = -1;
    p.beam_search.beam_size   = -1;
    p.beam_search.patience    = -1.0f;
    p.grammar_penalty  = 100.0f;
    p.vad_params       = whisper_vad_default_params();
    switch (strategy) {
        case WHISPER_SAMPLING_GREEDY:      p.greedy.best_of        = 5; break;
        case WHISPER_SAMPLING_BEAM_SEARCH: p.beam_search.beam_size = 5; break;
    }
    return p;
}

struct whisper_full_params * whisper_full_default_params_by_ref(
        enum whisper_sampling_strategy strategy) {
    struct whisper_full_params * p =
        (struct whisper_full_params *) malloc(sizeof(*p));
    if (p) *p = whisper_full_default_params(strategy);
    return p;
}

// [extension] ABI self-description for FFI consumers (bindings/java
// asserts its hand-declared FFM layout against this at startup)
size_t whisper_full_params_sizeof(void) {
    return sizeof(struct whisper_full_params);
}

// whisper.h:640-666 — params by value, callbacks live for the whole run
int whisper_full(struct whisper_context * ctx,
                 struct whisper_full_params params,
                 const float * samples, int n_samples) {
    return full_struct_call("full_struct", (long) (intptr_t) ctx, 0,
                            params, samples, n_samples, 0);
}

int whisper_full_with_state(struct whisper_context * ctx,
                            struct whisper_state * state,
                            struct whisper_full_params params,
                            const float * samples, int n_samples) {
    return full_struct_call("full_struct", (long) (intptr_t) ctx,
                            (long) (intptr_t) state, params, samples,
                            n_samples, 0);
}

int whisper_full_parallel(struct whisper_context * ctx,
                          struct whisper_full_params params,
                          const float * samples, int n_samples,
                          int n_processors) {
    return full_struct_call("full_parallel_struct", (long) (intptr_t) ctx, 0,
                            params, samples, n_samples,
                            n_processors > 0 ? n_processors : 1);
}

// struct-taking VAD segmenters (whisper.h:735-744): serialize the params
// and reuse the JSON entry points
static std::string vparams_to_json(whisper_vad_params p) {
    std::string out = "{";
    add_float(out, "threshold", p.threshold);
    add_int(out, "min_speech_duration_ms", p.min_speech_duration_ms);
    add_int(out, "min_silence_duration_ms", p.min_silence_duration_ms);
    add_float(out, "max_speech_duration_s", p.max_speech_duration_s);
    add_int(out, "speech_pad_ms", p.speech_pad_ms);
    add_float(out, "samples_overlap", p.samples_overlap);
    out.back() = '}';
    return out;
}

struct whisper_vad_segments * whisper_vad_segments_from_probs(
        struct whisper_vad_context * vctx, whisper_vad_params params) {
    return whisper_vad_segments_from_probs_json(
        vctx, vparams_to_json(params).c_str());
}

struct whisper_vad_segments * whisper_vad_segments_from_samples(
        struct whisper_vad_context * vctx, whisper_vad_params params,
        const float * samples, int n_samples) {
    return whisper_vad_segments_from_samples_json(
        vctx, vparams_to_json(params).c_str(), samples, n_samples);
}

}  // extern "C"

// ============================================================================
// Parakeet C ABI (include/parakeet.h:1-342) — the second model family's
// public C surface, forwarded to whisper_tpu_torch.capi_parakeet through the same
// embedded interpreter.  Context/state handles follow the whisper pattern:
// the opaque pointer value IS the Python handle (0 == NULL); passing
// state == NULL routes to the context's default state (sh=0), exactly like
// the reference's ctx->state.  See native/parakeet_tpu.h for the consumer
// declarations.
// ============================================================================

extern "C" {

struct parakeet_context;
struct parakeet_state;

typedef int32_t parakeet_token;

struct parakeet_context_params {
    bool use_gpu;
    int  gpu_device;
};

typedef struct parakeet_token_data {
    parakeet_token id;
    int duration_idx;
    int duration_value;
    int frame_index;
    float p;
    float plog;
    int64_t t0;
    int64_t t1;
    bool is_word_start;
} parakeet_token_data;

typedef struct parakeet_model_loader {
    void * context;
    size_t (*read)(void * ctx, void * output, size_t read_size);
    bool   (*eof)(void * ctx);
    void   (*close)(void * ctx);
} parakeet_model_loader;

enum parakeet_sampling_strategy {
    PARAKEET_SAMPLING_GREEDY,
};

typedef void (*parakeet_new_token_callback)(
        struct parakeet_context * ctx, struct parakeet_state * state,
        const parakeet_token_data * token_data, void * user_data);
typedef void (*parakeet_new_segment_callback)(
        struct parakeet_context * ctx, struct parakeet_state * state,
        int n_new, void * user_data);
typedef void (*parakeet_progress_callback)(
        struct parakeet_context * ctx, struct parakeet_state * state,
        int progress, void * user_data);
typedef bool (*parakeet_encoder_begin_callback)(
        struct parakeet_context * ctx, struct parakeet_state * state,
        void * user_data);

struct parakeet_full_params {
    enum parakeet_sampling_strategy strategy;

    int n_threads;
    int offset_ms;
    int duration_ms;

    bool no_context;

    int audio_ctx;

    parakeet_new_segment_callback new_segment_callback;
    void * new_segment_callback_user_data;

    parakeet_new_token_callback new_token_callback;
    void * new_token_callback_user_data;

    parakeet_progress_callback progress_callback;
    void * progress_callback_user_data;

    parakeet_encoder_begin_callback encoder_begin_callback;
    void * encoder_begin_callback_user_data;

    ggml_abort_callback abort_callback;
    void * abort_callback_user_data;
};

}  // extern "C" (declarations; definitions continue below)

namespace {

// serialize context params into pk_init_*'s cparams JSON
std::string pk_cparams_to_json(const struct parakeet_context_params & p) {
    std::string out = "{";
    add_bool(out, "use_gpu", p.use_gpu);
    add_int(out, "gpu_device", p.gpu_device);
    out.back() = '}';
    return out;
}

std::string pk_fparams_to_json(const struct parakeet_full_params & p) {
    std::string out = "{";
    add_int(out, "strategy", (int) p.strategy);
    add_int(out, "n_threads", p.n_threads);
    add_int(out, "offset_ms", p.offset_ms);
    add_int(out, "duration_ms", p.duration_ms);
    add_bool(out, "no_context", p.no_context);
    add_int(out, "audio_ctx", p.audio_ctx);
    out.back() = '}';
    return out;
}

// function-pointer addresses for capi_parakeet._pk_install_c_callbacks
std::string pk_callbacks_to_json(const struct parakeet_full_params & p) {
    std::string out = "{";
    add_int(out, "new_segment", (long long) (uintptr_t) p.new_segment_callback);
    add_int(out, "new_segment_ud", (long long) (uintptr_t) p.new_segment_callback_user_data);
    add_int(out, "new_token", (long long) (uintptr_t) p.new_token_callback);
    add_int(out, "new_token_ud", (long long) (uintptr_t) p.new_token_callback_user_data);
    add_int(out, "progress", (long long) (uintptr_t) p.progress_callback);
    add_int(out, "progress_ud", (long long) (uintptr_t) p.progress_callback_user_data);
    add_int(out, "encoder_begin", (long long) (uintptr_t) p.encoder_begin_callback);
    add_int(out, "encoder_begin_ud", (long long) (uintptr_t) p.encoder_begin_callback_user_data);
    add_int(out, "abort", (long long) (uintptr_t) p.abort_callback);
    add_int(out, "abort_ud", (long long) (uintptr_t) p.abort_callback_user_data);
    out.back() = '}';
    return out;
}

int pk_run(const char * pyfn, long h, long sh,
           const struct parakeet_full_params & params,
           const float * samples, int n_samples) {
    ensure_runtime();
    std::string pj = pk_fparams_to_json(params);
    std::string cj = pk_callbacks_to_json(params);
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * arr = np_f32_view(samples ? samples : (const float *) "",
                                 samples ? (Py_ssize_t) n_samples : 0);
    int rc = -1;
    if (arr) {
        PyObject * res = call(pyfn, Py_BuildValue("(l,l,s,s,O)", h, sh,
                                                  pj.c_str(), cj.c_str(),
                                                  arr));
        if (res) {
            rc = (int) PyLong_AsLong(res);
            Py_DECREF(res);
        }
        Py_DECREF(arr);
    }
    PyGILState_Release(gil);
    return rc;
}

}  // namespace

extern "C" {

const char * parakeet_version(void) {
    return call_str("pk_version", nullptr);
}

// ---- lifecycle -------------------------------------------------------------

struct parakeet_context * parakeet_init_from_file_with_params(
        const char * path_model, struct parakeet_context_params params) {
    std::string cj = pk_cparams_to_json(params);
    return (struct parakeet_context *) (intptr_t) call_long(
        "pk_init_from_file", 0, "(s,s)", path_model, cj.c_str());
}

struct parakeet_context * parakeet_init_from_buffer_with_params(
        void * buffer, size_t buffer_size,
        struct parakeet_context_params params) {
    ensure_runtime();
    std::string cj = pk_cparams_to_json(params);
    PyGILState_STATE gil = PyGILState_Ensure();
    // tuple built manually: Py_BuildValue's "y#" length-type depends on
    // PY_SSIZE_T_CLEAN-era headers — avoid the varargs pitfall entirely
    PyObject * args = PyTuple_New(2);
    PyTuple_SET_ITEM(args, 0, PyBytes_FromStringAndSize(
                                  (const char *) buffer,
                                  (Py_ssize_t) buffer_size));
    PyTuple_SET_ITEM(args, 1, PyUnicode_FromString(cj.c_str()));
    PyObject * res = call("pk_init_from_buffer", args);
    intptr_t h = 0;
    if (res) {
        h = (intptr_t) PyLong_AsLong(res);
        Py_DECREF(res);
    }
    PyGILState_Release(gil);
    return (struct parakeet_context *) h;
}

// drain a parakeet_model_loader into memory, then init from the buffer
struct parakeet_context * parakeet_init_with_params(
        struct parakeet_model_loader * loader,
        struct parakeet_context_params params) {
    if (!loader || !loader->read) return nullptr;
    std::vector<char> buf;
    char chunk[1 << 16];
    while (!(loader->eof && loader->eof(loader->context))) {
        size_t n = loader->read(loader->context, chunk, sizeof(chunk));
        if (n == 0) break;
        buf.insert(buf.end(), chunk, chunk + n);
    }
    if (loader->close) loader->close(loader->context);
    if (buf.empty()) return nullptr;
    return parakeet_init_from_buffer_with_params(buf.data(), buf.size(),
                                                 params);
}

// *_no_state: no separately-allocated XLA compute state to defer — aliases
struct parakeet_context * parakeet_init_from_file_with_params_no_state(
        const char * path_model, struct parakeet_context_params params) {
    return parakeet_init_from_file_with_params(path_model, params);
}

struct parakeet_context * parakeet_init_from_buffer_with_params_no_state(
        void * buffer, size_t buffer_size,
        struct parakeet_context_params params) {
    return parakeet_init_from_buffer_with_params(buffer, buffer_size, params);
}

struct parakeet_context * parakeet_init_with_params_no_state(
        struct parakeet_model_loader * loader,
        struct parakeet_context_params params) {
    return parakeet_init_with_params(loader, params);
}

struct parakeet_state * parakeet_init_state(struct parakeet_context * ctx) {
    return (struct parakeet_state *) (intptr_t) call_long(
        "pk_init_state", 0, "(l)", (long) (intptr_t) ctx);
}

void parakeet_free(struct parakeet_context * ctx) {
    if (!ctx) return;
    call_long("pk_free", 0, "(l)", (long) (intptr_t) ctx);
}

void parakeet_free_state(struct parakeet_state * state) {
    if (!state) return;
    call_long("pk_free_state", 0, "(l)", (long) (intptr_t) state);
}

void parakeet_free_params(struct parakeet_full_params * params) {
    free(params);
}

void parakeet_free_context_params(struct parakeet_context_params * params) {
    free(params);
}

// ---- pcm -> mel ------------------------------------------------------------

int parakeet_pcm_to_mel_with_state(struct parakeet_context * ctx,
                                   struct parakeet_state * state,
                                   const float * samples, int n_samples,
                                   int n_threads) {
    (void) n_threads;  // XLA owns threading
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * arr = np_f32_view(samples, (Py_ssize_t) n_samples);
    int rc = -1;
    if (arr) {
        PyObject * res = call("pk_pcm_to_mel",
                              Py_BuildValue("(l,l,O)", (long) (intptr_t) ctx,
                                            (long) (intptr_t) state, arr));
        if (res) { rc = (int) PyLong_AsLong(res); Py_DECREF(res); }
        Py_DECREF(arr);
    }
    PyGILState_Release(gil);
    return rc;
}

int parakeet_pcm_to_mel(struct parakeet_context * ctx, const float * samples,
                        int n_samples, int n_threads) {
    return parakeet_pcm_to_mel_with_state(ctx, nullptr, samples, n_samples,
                                          n_threads);
}

int parakeet_set_mel_with_state(struct parakeet_context * ctx,
                                struct parakeet_state * state,
                                const float * data, int n_len, int n_mel) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * arr = np_f32_view(data, (Py_ssize_t) n_len * n_mel);
    int rc = -1;
    if (arr) {
        PyObject * res = call("pk_set_mel",
                              Py_BuildValue("(l,l,O,i,i)",
                                            (long) (intptr_t) ctx,
                                            (long) (intptr_t) state, arr,
                                            n_len, n_mel));
        if (res) { rc = (int) PyLong_AsLong(res); Py_DECREF(res); }
        Py_DECREF(arr);
    }
    PyGILState_Release(gil);
    return rc;
}

int parakeet_set_mel(struct parakeet_context * ctx, const float * data,
                     int n_len, int n_mel) {
    return parakeet_set_mel_with_state(ctx, nullptr, data, n_len, n_mel);
}

// ---- encoder ---------------------------------------------------------------

int parakeet_encode_with_state(struct parakeet_context * ctx,
                               struct parakeet_state * state, int offset,
                               int n_threads) {
    (void) n_threads;
    return (int) call_long("pk_encode", -1, "(l,l,i)",
                           (long) (intptr_t) ctx, (long) (intptr_t) state,
                           offset);
}

int parakeet_encode(struct parakeet_context * ctx, int offset,
                    int n_threads) {
    return parakeet_encode_with_state(ctx, nullptr, offset, n_threads);
}

// ---- tokenizer -------------------------------------------------------------

int parakeet_tokenize(struct parakeet_context * ctx, const char * text,
                      parakeet_token * tokens, int n_max_tokens) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * res = call("pk_tokenize",
                          Py_BuildValue("(l,s)", (long) (intptr_t) ctx,
                                        text));
    int n = -1;
    if (res && PyList_Check(res)) {
        n = (int) PyList_GET_SIZE(res);
        if (!tokens || n > n_max_tokens) {
            n = -n;  // reference contract: negative count on overflow
        } else {
            for (int k = 0; k < n; k++) {
                tokens[k] = (parakeet_token) PyLong_AsLong(
                    PyList_GET_ITEM(res, k));
            }
        }
    }
    Py_XDECREF(res);
    PyGILState_Release(gil);
    return n;
}

int parakeet_token_count(struct parakeet_context * ctx, const char * text) {
    return (int) call_long("pk_token_count", -1, "(l,s)",
                           (long) (intptr_t) ctx, text);
}

// ---- introspection ----------------------------------------------------------

int parakeet_n_len(struct parakeet_context * ctx) {
    return (int) call_long("pk_n_len", 0, "(l)", (long) (intptr_t) ctx);
}

int parakeet_n_len_from_state(struct parakeet_state * state) {
    return (int) call_long("pk_n_len_from_state", 0, "(l)",
                           (long) (intptr_t) state);
}

int parakeet_n_vocab(struct parakeet_context * ctx) {
    return (int) call_long("pk_n_vocab", 0, "(l)", (long) (intptr_t) ctx);
}

int parakeet_n_audio_ctx(struct parakeet_context * ctx) {
    return (int) call_long("pk_n_audio_ctx", 0, "(l)", (long) (intptr_t) ctx);
}

int parakeet_model_n_vocab(struct parakeet_context * ctx) {
    return parakeet_n_vocab(ctx);
}

int parakeet_model_n_audio_ctx(struct parakeet_context * ctx) {
    return parakeet_n_audio_ctx(ctx);
}

int parakeet_model_n_audio_state(struct parakeet_context * ctx) {
    return (int) call_long("pk_model_n_audio_state", 0, "(l)",
                           (long) (intptr_t) ctx);
}

int parakeet_model_n_audio_head(struct parakeet_context * ctx) {
    return (int) call_long("pk_model_n_audio_head", 0, "(l)",
                           (long) (intptr_t) ctx);
}

int parakeet_model_n_audio_layer(struct parakeet_context * ctx) {
    return (int) call_long("pk_model_n_audio_layer", 0, "(l)",
                           (long) (intptr_t) ctx);
}

int parakeet_model_n_mels(struct parakeet_context * ctx) {
    return (int) call_long("pk_model_n_mels", 0, "(l)",
                           (long) (intptr_t) ctx);
}

int parakeet_model_ftype(struct parakeet_context * ctx) {
    return (int) call_long("pk_model_ftype", 0, "(l)",
                           (long) (intptr_t) ctx);
}

// ---- logits (rows = decoded tokens of the last full/chunk) ------------------

int parakeet_n_logits_rows(struct parakeet_context * ctx) {
    return (int) call_long("pk_n_logits_rows", 0, "(l,l)",
                           (long) (intptr_t) ctx, 0L);
}

int parakeet_n_logits_cols(struct parakeet_context * ctx) {
    return (int) call_long("pk_n_logits_cols", 0, "(l,l)",
                           (long) (intptr_t) ctx, 0L);
}

static float * pk_logits_buffer(long h, long sh) {
    static std::mutex mu;
    static std::map<long, std::vector<float>> bufs;
    long rows = call_long("pk_n_logits_rows", 0, "(l,l)", h, sh);
    long cols = call_long("pk_n_logits_cols", 0, "(l,l)", h, sh);
    std::lock_guard<std::mutex> lock(mu);
    std::vector<float> & buf = bufs[sh ? -sh : h];
    buf.resize((size_t) (rows > 0 ? rows * cols : 0));
    if (rows > 0) {
        call_bytes_out("pk_get_logits_bytes", (char *) buf.data(),
                       (long) buf.size() * 4, "(l,l)", h, sh);
    }
    return buf.data();
}

float * parakeet_get_logits(struct parakeet_context * ctx) {
    return pk_logits_buffer((long) (intptr_t) ctx, 0);
}

float * parakeet_get_logits_from_state(struct parakeet_state * state) {
    return pk_logits_buffer(0, (long) (intptr_t) state);
}

// ---- token strings -----------------------------------------------------------

const char * parakeet_token_to_str(struct parakeet_context * ctx,
                                   parakeet_token token) {
    return call_str("pk_token_to_str", "(l,i)", (long) (intptr_t) ctx,
                    (int) token);
}

int parakeet_token_to_text(const char * token_str, bool is_first,
                           char * output, int max_len) {
    if (!token_str || !output || max_len <= 0) return -1;
    const char * s = call_str("pk_token_to_text", "(s,i)", token_str,
                              is_first ? 1 : 0);
    int n = (int) strlen(s);
    if (n >= max_len) n = max_len - 1;
    memcpy(output, s, (size_t) n);
    output[n] = '\0';
    return n;
}

parakeet_token parakeet_token_blank(struct parakeet_context * ctx) {
    return (parakeet_token) call_long("pk_token_blank", -1, "(l)",
                                      (long) (intptr_t) ctx);
}

parakeet_token parakeet_token_unk(struct parakeet_context * ctx) {
    return (parakeet_token) call_long("pk_token_unk", -1, "(l)",
                                      (long) (intptr_t) ctx);
}

parakeet_token parakeet_token_bos(struct parakeet_context * ctx) {
    return (parakeet_token) call_long("pk_token_bos", -1, "(l)",
                                      (long) (intptr_t) ctx);
}

// ---- timings ----------------------------------------------------------------

struct parakeet_timings {
    float sample_ms;
    float encode_ms;
    float decode_ms;
};

struct parakeet_timings * parakeet_get_timings(struct parakeet_context * ctx) {
    static std::mutex mu;
    static std::map<long, parakeet_timings> slots;
    long h = (long) (intptr_t) ctx;
    char packed[sizeof(parakeet_timings)] = {0};
    call_bytes_out("pk_get_timings_packed", packed, sizeof(packed),
                   "(l)", h);
    std::lock_guard<std::mutex> lock(mu);
    parakeet_timings & t = slots[h];
    memcpy(&t, packed, sizeof(t));
    return &t;
}

void parakeet_print_timings(struct parakeet_context * ctx) {
    call_long("pk_print_timings", 0, "(l)", (long) (intptr_t) ctx);
}

void parakeet_reset_timings(struct parakeet_context * ctx) {
    call_long("pk_reset_timings", 0, "(l)", (long) (intptr_t) ctx);
}

const char * parakeet_print_system_info(void) {
    return call_str("pk_system_info", nullptr);
}

// ---- context/full default params ---------------------------------------------

struct parakeet_context_params parakeet_context_default_params(void) {
    struct parakeet_context_params p;
    memset(&p, 0, sizeof(p));
    p.use_gpu = true;  // reference default (src/parakeet.cpp:3500-3510)
    p.gpu_device = 0;
    return p;
}

struct parakeet_context_params * parakeet_context_default_params_by_ref(void) {
    struct parakeet_context_params * p =
        (struct parakeet_context_params *) malloc(sizeof(*p));
    if (p) *p = parakeet_context_default_params();
    return p;
}

// reference defaults, src/parakeet.cpp:3526-3548 (n_threads accepted but
// XLA owns threading)
struct parakeet_full_params parakeet_full_default_params(
        enum parakeet_sampling_strategy strategy) {
    struct parakeet_full_params p;
    memset(&p, 0, sizeof(p));
    p.strategy   = strategy;
    p.n_threads  = 4;
    p.no_context = true;
    p.audio_ctx  = 0;
    return p;
}

struct parakeet_full_params * parakeet_full_default_params_by_ref(
        enum parakeet_sampling_strategy strategy) {
    struct parakeet_full_params * p =
        (struct parakeet_full_params *) malloc(sizeof(*p));
    if (p) *p = parakeet_full_default_params(strategy);
    return p;
}

const char * parakeet_full_default_params_json(int strategy) {
    return call_str("pk_full_default_params_json", "(i)", strategy);
}

// ---- run the model -------------------------------------------------------------

int parakeet_full(struct parakeet_context * ctx,
                  struct parakeet_full_params params,
                  const float * samples, int n_samples) {
    return pk_run("pk_full", (long) (intptr_t) ctx, 0, params, samples,
                  n_samples);
}

int parakeet_full_with_state(struct parakeet_context * ctx,
                             struct parakeet_state * state,
                             struct parakeet_full_params params,
                             const float * samples, int n_samples) {
    return pk_run("pk_full", (long) (intptr_t) ctx,
                  (long) (intptr_t) state, params, samples, n_samples);
}

int parakeet_chunk(struct parakeet_context * ctx,
                   struct parakeet_state * state,
                   struct parakeet_full_params params,
                   const float * samples, int n_samples) {
    return pk_run("pk_chunk", (long) (intptr_t) ctx,
                  (long) (intptr_t) state, params, samples, n_samples);
}

int parakeet_full_json(struct parakeet_context * ctx,
                       const char * params_json,
                       const float * samples, int n_samples) {
    ensure_runtime();
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject * arr = np_f32_view(samples, (Py_ssize_t) n_samples);
    int rc = -1;
    if (arr) {
        PyObject * res = call("pk_full",
                              Py_BuildValue("(l,l,s,s,O)",
                                            (long) (intptr_t) ctx, 0L,
                                            params_json, "{}", arr));
        if (res) { rc = (int) PyLong_AsLong(res); Py_DECREF(res); }
        Py_DECREF(arr);
    }
    PyGILState_Release(gil);
    return rc;
}

// ---- results --------------------------------------------------------------------

int parakeet_full_n_segments(struct parakeet_context * ctx) {
    return (int) call_long("pk_full_n_segments", 0, "(l)",
                           (long) (intptr_t) ctx);
}

int parakeet_full_n_segments_from_state(struct parakeet_state * state) {
    return (int) call_long("pk_full_n_segments_from_state", 0, "(l)",
                           (long) (intptr_t) state);
}

int64_t parakeet_full_get_segment_t0(struct parakeet_context * ctx, int i) {
    return (int64_t) call_long("pk_full_get_segment_t0", -1, "(l,l,i)",
                               (long) (intptr_t) ctx, 0L, i);
}

int64_t parakeet_full_get_segment_t0_from_state(struct parakeet_state * state,
                                                int i) {
    return (int64_t) call_long("pk_full_get_segment_t0", -1, "(l,l,i)",
                               0L, (long) (intptr_t) state, i);
}

int64_t parakeet_full_get_segment_t1(struct parakeet_context * ctx, int i) {
    return (int64_t) call_long("pk_full_get_segment_t1", -1, "(l,l,i)",
                               (long) (intptr_t) ctx, 0L, i);
}

int64_t parakeet_full_get_segment_t1_from_state(struct parakeet_state * state,
                                                int i) {
    return (int64_t) call_long("pk_full_get_segment_t1", -1, "(l,l,i)",
                               0L, (long) (intptr_t) state, i);
}

const char * parakeet_full_get_segment_text(struct parakeet_context * ctx,
                                            int i) {
    return call_str("pk_full_get_segment_text", "(l,l,i)",
                    (long) (intptr_t) ctx, 0L, i);
}

const char * parakeet_full_get_segment_text_from_state(
        struct parakeet_state * state, int i) {
    return call_str("pk_full_get_segment_text", "(l,l,i)",
                    0L, (long) (intptr_t) state, i);
}

int parakeet_full_n_tokens(struct parakeet_context * ctx, int i) {
    return (int) call_long("pk_full_n_tokens", 0, "(l,l,i)",
                           (long) (intptr_t) ctx, 0L, i);
}

int parakeet_full_n_tokens_from_state(struct parakeet_state * state, int i) {
    return (int) call_long("pk_full_n_tokens", 0, "(l,l,i)",
                           0L, (long) (intptr_t) state, i);
}

const char * parakeet_full_get_token_text(struct parakeet_context * ctx,
                                          int i, int j) {
    return call_str("pk_full_get_token_text", "(l,l,i,i)",
                    (long) (intptr_t) ctx, 0L, i, j);
}

const char * parakeet_full_get_token_text_from_state(
        struct parakeet_context * ctx, struct parakeet_state * state,
        int i, int j) {
    return call_str("pk_full_get_token_text", "(l,l,i,i)",
                    (long) (intptr_t) ctx, (long) (intptr_t) state, i, j);
}

parakeet_token parakeet_full_get_token_id(struct parakeet_context * ctx,
                                          int i, int j) {
    return (parakeet_token) call_long("pk_full_get_token_id", -1,
                                      "(l,l,i,i)", (long) (intptr_t) ctx,
                                      0L, i, j);
}

parakeet_token parakeet_full_get_token_id_from_state(
        struct parakeet_state * state, int i, int j) {
    return (parakeet_token) call_long("pk_full_get_token_id", -1,
                                      "(l,l,i,i)", 0L,
                                      (long) (intptr_t) state, i, j);
}

static parakeet_token_data pk_token_data_fetch(long h, long sh, int i, int j) {
    parakeet_token_data td;
    memset(&td, 0, sizeof(td));
    char packed[48] = {0};
    long n = call_bytes_out("pk_full_get_token_data_packed", packed,
                            sizeof(packed), "(l,l,i,i)", h, sh, i, j);
    if (n == sizeof(packed)) {
        // packed layout == struct layout (<4i2f2q?7x, 48 bytes)
        memcpy(&td, packed, sizeof(td) < sizeof(packed) ? sizeof(td)
                                                        : sizeof(packed));
    }
    return td;
}

parakeet_token_data parakeet_full_get_token_data(
        struct parakeet_context * ctx, int i, int j) {
    return pk_token_data_fetch((long) (intptr_t) ctx, 0, i, j);
}

parakeet_token_data parakeet_full_get_token_data_from_state(
        struct parakeet_state * state, int i, int j) {
    return pk_token_data_fetch(0, (long) (intptr_t) state, i, j);
}

float parakeet_full_get_token_p(struct parakeet_context * ctx, int i, int j) {
    return (float) call_double("pk_full_get_token_p", 0.0, "(l,l,i,i)",
                               (long) (intptr_t) ctx, 0L, i, j);
}

float parakeet_full_get_token_p_from_state(struct parakeet_state * state,
                                           int i, int j) {
    return (float) call_double("pk_full_get_token_p", 0.0, "(l,l,i,i)",
                               0L, (long) (intptr_t) state, i, j);
}

// ---- logging (shared sink with whisper_log_set) -----------------------------

void parakeet_log_set(whisper_log_callback callback, void * user_data) {
    whisper_log_set(callback, user_data);
}

}  // extern "C"
