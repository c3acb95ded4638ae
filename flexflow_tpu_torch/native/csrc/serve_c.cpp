// Native C serving ABI of the PyTorch port: config create/parse, model
// build, weight load, request registration and generate -- the surface
// that lets a NON-PYTHON host embed the whole serving system, like the
// reference's C API does for its C++ mains (reference src/c/flexflow_c.cc;
// flexflow_model_generate at :1584 driven by
// inference/incr_decoding/incr_decoding.cc:118).
//
// A copy of native/src/serve_c.cpp that drives the port instead of the
// JAX package: this library embeds CPython and calls the flat functions
// in flexflow_tpu_torch/serve/capi_host.py. It exports the same ffsv_*
// symbols (native/include/flexflow_tpu_c.h), so the C mains of
// examples/c link against it unchanged. The C host never sees a PyObject
// type -- handles are opaque void*, errors surface through
// ffsv_last_error(). Single-threaded host assumed (the embedded
// interpreter runs on the caller's thread).
//
// Built by flexflow_tpu_torch.native.build_serve_library into
// flexflow_tpu_torch/native/_build/libflexflow_tpu_torch_serve.so:
//   g++ -O2 -std=c++17 -fPIC -Wall -shared -I native/include \
//       -I <python include> serve_c.cpp -L<libdir> -lpython3.x

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>
#include <string>
#include <vector>

#include "flexflow_tpu_c.h"

namespace {

std::string g_error;
PyObject *g_host = nullptr;  // the flexflow_tpu_torch capi_host module

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_error = "python error";
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c) g_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

PyObject *call(const char *fn, PyObject *args) {
  // args: a NEW reference to a tuple (stolen here), or nullptr for ().
  if (!g_host) {
    // checked FIRST: before ffsv_init there may be no interpreter, and
    // PyErr_Occurred without a thread state would crash
    g_error = "ffsv_init not called";
    Py_XDECREF(args);
    return nullptr;
  }
  // A nullptr WITH a pending exception means the caller's Py_BuildValue
  // failed (e.g. non-UTF-8 text) — surface that error instead of
  // invoking the function zero-arg under a pending exception.
  if (!args && PyErr_Occurred()) {
    set_error_from_python();
    return nullptr;
  }
  PyObject *f = PyObject_GetAttrString(g_host, fn);
  if (!f) {
    set_error_from_python();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject *a = args ? args : PyTuple_New(0);
  PyObject *r = PyObject_CallObject(f, a);
  Py_DECREF(f);
  Py_DECREF(a);
  if (!r) set_error_from_python();
  return r;
}

}  // namespace

extern "C" {

const char *ffsv_last_error(void) { return g_error.c_str(); }

/* Initialize the embedded runtime. repo_root: directory containing the
 * flexflow_tpu_torch package (prepended to sys.path; pass NULL if the
 * package is already importable). Returns 0 on success. */
int ffsv_init(const char *repo_root) {
  if (g_host) return 0;
  if (!Py_IsInitialized()) Py_Initialize();
  if (repo_root && *repo_root) {
    PyObject *sys_path = PySys_GetObject("path");  // borrowed
    PyObject *p = PyUnicode_FromString(repo_root);
    if (sys_path && p) PyList_Insert(sys_path, 0, p);
    Py_XDECREF(p);
  }
  g_host = PyImport_ImportModule("flexflow_tpu_torch.serve.capi_host");
  if (!g_host) {
    set_error_from_python();
    return -1;
  }
  /* Embedded-host-only setup (the FFSV_DEVICE choice) runs HERE, not at
   * module import: ordinary Python importers of capi_host must not have
   * their interpreter's device choice changed as a side effect. */
  PyObject *r = call("host_init", nullptr);
  if (!r) {
    Py_CLEAR(g_host);
    return -1;
  }
  Py_DECREF(r);
  return 0;
}

/* Tear down handles (the interpreter stays up: the CUDA context and
 * loaded extension modules do not survive re-initialization). */
void ffsv_release(void *handle) { Py_XDECREF((PyObject *)handle); }

void *ffsv_config_create(void) { return call("config_create", nullptr); }

/* Reference flexflow_config_parse_args: argv of reference-style flags. */
void *ffsv_config_parse_args(int argc, const char **argv) {
  if (!g_host) {
    g_error = "ffsv_init not called";
    return nullptr;
  }
  PyObject *lst = PyList_New(argc);
  if (!lst) {
    set_error_from_python();
    return nullptr;
  }
  for (int i = 0; i < argc; i++) {
    PyObject *s = PyUnicode_FromString(argv[i]);
    if (!s) {
      /* non-UTF-8 argv: a NULL element would make the later tuple
       * conversion/call segfault the embedding host — fail loudly with
       * ffsv_last_error set instead (ADVICE r5) */
      set_error_from_python();
      Py_DECREF(lst);
      return nullptr;
    }
    PyList_SetItem(lst, i, s);
  }
  return call("config_parse_args", Py_BuildValue("(N)", lst));
}

int ffsv_config_set(void *cfg, const char *key, const char *value) {
  PyObject *r = call("config_set",
                     Py_BuildValue("(Oss)", (PyObject *)cfg, key, value));
  if (!r) return -1;
  long v = PyLong_AsLong(r);
  Py_DECREF(r);
  return (int)v;
}

/* Returns a malloc'd string the caller frees, or NULL. */
char *ffsv_config_get(void *cfg, const char *key) {
  PyObject *r = call("config_get",
                     Py_BuildValue("(Os)", (PyObject *)cfg, key));
  if (!r) return nullptr;
  const char *c = PyUnicode_AsUTF8(r);
  char *out = c ? strdup(c) : nullptr;
  Py_DECREF(r);
  return out;
}

/* Build + compile a serving model from the JSON spec documented in
 * capi_host.llm_create (family, model_config, mode, weights_npz,
 * checkpoint_dir, quantize, generation_config -- the optional
 * adaptive-speculation policy object; see flexflow_tpu_c.h for the key
 * set). */
void *ffsv_llm_create(void *cfg, const char *spec_json) {
  return call("llm_create",
              Py_BuildValue("(Os)", (PyObject *)cfg, spec_json));
}

/* Register a tokenized prompt; returns the request guid or -1. */
long ffsv_register_request(void *llm, const int32_t *tokens, int n_tokens,
                           int max_new_tokens) {
  PyObject *lst = PyList_New(n_tokens);
  for (int i = 0; i < n_tokens; i++)
    PyList_SetItem(lst, i, PyLong_FromLong(tokens[i]));
  PyObject *r = call("register_request",
                     Py_BuildValue("(ONi)", (PyObject *)llm, lst,
                                   max_new_tokens));
  if (!r) return -1;
  long guid = PyLong_AsLong(r);
  Py_DECREF(r);
  return guid;
}

/* Register a tokenized prompt with a per-request wall-clock timeout
 * (seconds; <= 0 = none). Past the deadline the request is cancelled
 * between decode rounds and resolves as timed_out with its partial
 * output. Returns the request guid or -1. */
long ffsv_register_request_timeout(void *llm, const int32_t *tokens,
                                   int n_tokens, int max_new_tokens,
                                   double timeout_s) {
  PyObject *lst = PyList_New(n_tokens);
  for (int i = 0; i < n_tokens; i++)
    PyList_SetItem(lst, i, PyLong_FromLong(tokens[i]));
  PyObject *r = call("register_request_timeout",
                     Py_BuildValue("(ONid)", (PyObject *)llm, lst,
                                   max_new_tokens, timeout_s));
  if (!r) return -1;
  long guid = PyLong_AsLong(r);
  Py_DECREF(r);
  return guid;
}

/* Flag a registered request for cancellation; the next generate round
 * reaps it (slot freed, partial output kept, status -> cancelled).
 * Returns 1 if cancelled, 0 if unknown/finished, -1 on error. */
int ffsv_request_cancel(void *llm, long guid) {
  PyObject *r = call("request_cancel",
                     Py_BuildValue("(Ol)", (PyObject *)llm, guid));
  if (!r) return -1;
  long v = PyLong_AsLong(r);
  Py_DECREF(r);
  return (int)v;
}

/* Resolution status of a request: -1 unknown, 0 ok, 1 timed_out,
 * 2 cancelled, 3 error, 4 registered-but-unfinished. */
int ffsv_request_status(void *llm, long guid) {
  PyObject *r = call("request_status",
                     Py_BuildValue("(Ol)", (PyObject *)llm, guid));
  if (!r) return -1;
  long v = PyLong_AsLong(r);
  Py_DECREF(r);
  return (int)v;
}

/* Build + compile a speculative-decoding pair: verifier (tree-verify
 * mode) + draft SSM(s) (beam-search mode) — the reference's spec_infer
 * main (inference/spec_infer/spec_infer.cc:201). Both specs use the
 * llm_create JSON schema; draft_json may be {"ssms":[spec, ...]} for
 * multi-SSM merged-tree drafting, and the verifier spec's
 * generation_config carries the adaptive-speculation policy (depth
 * bounds, fallback threshold — flexflow_tpu_c.h). Register requests
 * and call ffsv_generate_spec on the returned handle. */
void *ffsv_spec_create(void *cfg, const char *verifier_json,
                       const char *draft_json) {
  return call("spec_create", Py_BuildValue("(Oss)", (PyObject *)cfg,
                                           verifier_json, draft_json));
}

/* Speculative decoding for every pending request. Returns finished
 * count, or -1. spec_depth must be >= 1; generation_config.spec_depth
 * (verifier spec JSON) overrides it when set. */
int ffsv_generate_spec(void *llm, int spec_depth) {
  PyObject *r = call("generate_spec",
                     Py_BuildValue("(Oi)", (PyObject *)llm, spec_depth));
  if (!r) return -1;
  long n = PyLong_AsLong(r);
  Py_DECREF(r);
  return (int)n;
}

/* Run incremental decoding for every pending request (reference
 * flexflow_model_generate). Returns finished-request count or -1. */
int ffsv_generate(void *llm) {
  PyObject *r = call("generate", Py_BuildValue("(O)", (PyObject *)llm));
  if (!r) return -1;
  long n = PyLong_AsLong(r);
  Py_DECREF(r);
  return (int)n;
}

/* Attach the GPT-2 BPE tokenizer (native C++ when available) so the
 * host takes text prompts — reference flexflow_model_generate's text
 * surface. Returns the vocab size, or -1. */
int ffsv_register_bpe_tokenizer(void *llm, const char *vocab_json_path,
                                const char *merges_path) {
  PyObject *r = call("register_bpe_tokenizer",
                     Py_BuildValue("(Oss)", (PyObject *)llm,
                                   vocab_json_path, merges_path));
  if (!r) return -1;
  long n = PyLong_AsLong(r);
  Py_DECREF(r);
  return (int)n;
}

/* Register a TEXT prompt (requires a registered tokenizer); returns the
 * request guid, or -1. */
long ffsv_register_request_text(void *llm, const char *text,
                                int max_new_tokens) {
  PyObject *r = call("register_request_text",
                     Py_BuildValue("(Osi)", (PyObject *)llm, text,
                                   max_new_tokens));
  if (!r) return -1;
  long guid = PyLong_AsLong(r);
  Py_DECREF(r);
  return guid;
}

/* Decode a finished request's output to text (malloc'd; caller frees),
 * or NULL. */
char *ffsv_get_output_text(void *llm, long guid) {
  PyObject *r = call("get_output_text",
                     Py_BuildValue("(Ol)", (PyObject *)llm, guid));
  if (!r) return nullptr;
  const char *c = PyUnicode_AsUTF8(r);
  char *out = c ? strdup(c) : nullptr;
  Py_DECREF(r);
  return out;
}

/* Snapshot the serving telemetry registry ("json" or "prometheus");
 * malloc'd string the caller frees, or NULL on error. Empty snapshot
 * ("{}" / "") when telemetry is disabled — enable via
 * ffsv_config_set(cfg, "telemetry", "true") before ffsv_llm_create.
 * With a replica fleet live in-process the dump aggregates the global
 * registry plus every replica registry (counters sum, histograms merge
 * bucket-exactly) — see flexflow_tpu_c.h for the full contract. */
char *ffsv_metrics_dump(const char *format) {
  PyObject *r = call("metrics_dump",
                     Py_BuildValue("(s)", format ? format : "json"));
  if (!r) return nullptr;
  const char *c = PyUnicode_AsUTF8(r);
  char *out = c ? strdup(c) : nullptr;
  Py_DECREF(r);
  return out;
}

/* Copy a finished request's output tokens into out (cap entries max);
 * returns the token count (may exceed cap; call again with more room)
 * or -1 on error. */
int ffsv_get_output(void *llm, long guid, int32_t *out, int cap) {
  PyObject *r = call("get_output",
                     Py_BuildValue("(Ol)", (PyObject *)llm, guid));
  if (!r) return -1;
  int n = (int)PyList_Size(r);
  for (int i = 0; i < n && i < cap; i++)
    out[i] = (int32_t)PyLong_AsLong(PyList_GetItem(r, i));
  Py_DECREF(r);
  return n;
}

}  // extern "C"
