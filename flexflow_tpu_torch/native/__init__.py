"""The port's native (C++) host-side components, bound through ctypes
(counterpart of ``flexflow_tpu/native/__init__.py``).

Two shared libraries are built with ``g++`` from the repository's own
sources at first use, into ``flexflow_tpu_torch/native/_build/``:

* ``libflexflow_tpu_torch_native.so`` from ``native/src/
  {bpe_tokenizer,batch_scheduler,sp_tokenizer,graph_builder}.cpp`` (the
  GPT-2 BPE and SentencePiece tokenizers, the continuous-batching
  scheduler and the ``ffgb_*`` C model-graph builder that
  ``graph_builder.py`` binds), loaded with ``load_native``;
* ``libflexflow_tpu_torch_serve.so`` from ``native/csrc/serve_c.cpp``, the
  ``ffsv_*`` C serving ABI that embeds CPython and drives
  ``serve/capi_host.py`` (``build_serve_library``).

A library is rebuilt when the digest of its sources, headers, flags, the
compiler's version text and the Python version changes (a tree copied to
another machine rebuilds there). Builds run under a file lock and write
to a temporary name that ``os.replace`` puts in place, so several
processes may ask for the same library at once. A build that fails
raises ``NativeBuildError`` with the compiler's output: unlike the JAX
package, which falls back to pure Python when its library cannot build,
the port never silently runs without the native code it was asked for.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from typing import List, Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_PKG_DIR))
NATIVE_SRC = os.path.join(_REPO_ROOT, "native", "src")
NATIVE_INCLUDE = os.path.join(_REPO_ROOT, "native", "include")
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NATIVE_LIB = "libflexflow_tpu_torch_native.so"
SERVE_LIB = "libflexflow_tpu_torch_serve.so"
# the C++ compiler; tests point it at a missing binary to exercise the
# failed-build path
CXX = "g++"
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """A native library could not be built (the compiler's output is in
    the message)."""


def native_sources() -> List[str]:
    return [os.path.join(NATIVE_SRC, f) for f in
            ("bpe_tokenizer.cpp", "batch_scheduler.cpp", "sp_tokenizer.cpp",
             "graph_builder.cpp")]


def python_build_flags():
    """(include flags, link flags) for code that embeds this Python."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldver = sysconfig.get_config_var("LDVERSION") or ""
    return (["-I", inc], ["-L" + libdir, "-lpython" + ldver])


@functools.lru_cache(maxsize=None)
def _compiler_id(cxx: str) -> str:
    try:
        r = subprocess.run([cxx, "--version"], capture_output=True,
                           text=True, timeout=60)
    except OSError as e:
        raise NativeBuildError(
            f"cannot run the C++ compiler {cxx!r}: {e}") from e
    return r.stdout


def _digest(paths, cmd) -> str:
    h = hashlib.sha1(" ".join(cmd).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _build(out_name: str, sources: List[str], extra: List[str]) -> str:
    """Build ``out_name`` in BUILD_DIR from ``sources`` unless its digest
    stamp is current; return its path. Raises NativeBuildError."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, out_name)
    hdr = os.path.join(NATIVE_INCLUDE, "flexflow_tpu_c.h")
    base = [CXX, *CXXFLAGS, "-I", NATIVE_INCLUDE]
    digest = _digest(sources + [hdr], base + extra
                     + [_compiler_id(CXX), sys.version])
    stamp = out + ".sha1"
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if os.path.exists(out) and os.path.exists(stamp):
                with open(stamp) as f:
                    if f.read().strip() == digest:
                        return out
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = base + ["-o", tmp] + sources + extra
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
            if r.returncode != 0:
                raise NativeBuildError(
                    f"building {out_name} failed (exit {r.returncode}): "
                    f"{' '.join(cmd)}\n{r.stderr}")
            os.replace(tmp, out)
            with open(stamp, "w") as f:
                f.write(digest)
            return out
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)


def build_native_library() -> str:
    return _build(NATIVE_LIB, native_sources(), [])


def build_serve_library() -> str:
    """Build the ``ffsv_*`` serving ABI against this Python's headers and
    libpython; returns its path. Raises NativeBuildError (for example
    where ``Python.h`` is missing)."""
    inc, link = python_build_flags()
    return _build(SERVE_LIB, [os.path.join(CSRC, "serve_c.cpp")],
                  inc + link)


def _declare(lib: ctypes.CDLL):
    c = ctypes
    i32p = c.POINTER(c.c_int32)
    u8p = c.POINTER(c.c_uint8)
    lib.ffbpe_create.restype = c.c_void_p
    lib.ffbpe_create.argtypes = [c.c_char_p, c.c_char_p]
    lib.ffbpe_create_from_buffers.restype = c.c_void_p
    lib.ffbpe_create_from_buffers.argtypes = [c.c_char_p, c.c_char_p]
    lib.ffbpe_destroy.argtypes = [c.c_void_p]
    lib.ffbpe_vocab_size.restype = c.c_int
    lib.ffbpe_vocab_size.argtypes = [c.c_void_p]
    lib.ffbpe_encode.restype = c.c_int
    lib.ffbpe_encode.argtypes = [c.c_void_p, c.c_char_p, c.c_int, i32p,
                                 c.c_int]
    lib.ffbpe_decode.restype = c.c_int
    lib.ffbpe_decode.argtypes = [c.c_void_p, i32p, c.c_int, c.c_char_p,
                                 c.c_int]

    lib.ffs_create.restype = c.c_void_p
    lib.ffs_create.argtypes = [c.c_int, c.c_int, c.c_int64]
    lib.ffs_destroy.argtypes = [c.c_void_p]
    lib.ffs_add_request.argtypes = [c.c_void_p, c.c_int64, i32p, c.c_int,
                                    c.c_int, c.c_int]
    lib.ffs_has_work.restype = c.c_int
    lib.ffs_has_work.argtypes = [c.c_void_p]
    lib.ffs_fill_slots.restype = c.c_int
    lib.ffs_fill_slots.argtypes = [c.c_void_p]
    lib.ffs_assemble_prefill.restype = c.c_int
    lib.ffs_assemble_prefill.argtypes = [c.c_void_p, c.c_int, c.c_int,
                                         c.c_int, i32p, i32p, i32p, i32p, u8p]
    lib.ffs_assemble_decode.restype = c.c_int
    lib.ffs_assemble_decode.argtypes = [c.c_void_p, i32p, i32p, u8p]
    lib.ffs_decode_block.restype = c.c_int
    lib.ffs_decode_block.argtypes = [c.c_void_p, c.c_int]
    lib.ffs_append_block.restype = c.c_int
    lib.ffs_append_block.argtypes = [c.c_void_p, i32p, c.c_int]
    lib.ffs_cancel.restype = c.c_int
    lib.ffs_cancel.argtypes = [c.c_void_p, c.c_int64]
    lib.ffs_pop_done.restype = c.c_int
    lib.ffs_pop_done.argtypes = [c.c_void_p, c.POINTER(c.c_int64), i32p]
    lib.ffs_done_tokens.restype = c.c_int
    lib.ffs_done_tokens.argtypes = [c.c_void_p, c.c_int64, i32p, c.c_int]
    lib.ffs_prompt_len.restype = c.c_int
    lib.ffs_prompt_len.argtypes = [c.c_void_p, c.c_int64]

    lib.ffsp_create_from_buffer.restype = c.c_void_p
    lib.ffsp_create_from_buffer.argtypes = [c.c_char_p, c.c_int]
    lib.ffsp_destroy.argtypes = [c.c_void_p]
    lib.ffsp_encode.restype = c.c_int
    lib.ffsp_encode.argtypes = [c.c_void_p, c.c_char_p, c.c_int, i32p,
                                c.c_int]
    lib.ffsp_decode.restype = c.c_int
    lib.ffsp_decode.argtypes = [c.c_void_p, i32p, c.c_int, c.c_char_p,
                                c.c_int]

    ip = c.POINTER(c.c_int)
    lib.ffgb_create.restype = c.c_void_p
    lib.ffgb_create.argtypes = []
    lib.ffgb_destroy.argtypes = [c.c_void_p]
    for fn, extra in (("ffgb_input", [c.c_int, c.c_char_p]),
                      ("ffgb_dense", [c.c_int, c.c_int, c.c_int,
                                      c.c_char_p]),
                      ("ffgb_conv2d", [c.c_int] * 9 + [c.c_int,
                                                       c.c_char_p]),
                      ("ffgb_pool2d", [c.c_int] * 8 + [c.c_char_p]),
                      ("ffgb_unary", [c.c_int, c.c_char_p, c.c_char_p]),
                      ("ffgb_binary", [c.c_int, c.c_int, c.c_char_p,
                                       c.c_char_p]),
                      ("ffgb_concat", [ip, c.c_int, c.c_int, c.c_char_p]),
                      ("ffgb_softmax", [c.c_int, c.c_int, c.c_char_p]),
                      ("ffgb_dropout", [c.c_int, c.c_double, c.c_char_p]),
                      ("ffgb_embedding", [c.c_int, c.c_int, c.c_int,
                                          c.c_char_p]),
                      ("ffgb_reshape", [c.c_int, ip, c.c_int, c.c_char_p]),
                      ("ffgb_layer_norm", [c.c_int, ip, c.c_int, c.c_int,
                                           c.c_double, c.c_char_p]),
                      ("ffgb_batch_norm", [c.c_int, c.c_char_p]),
                      ("ffgb_rms_norm", [c.c_int, c.c_double, c.c_int,
                                         c.c_char_p]),
                      ("ffgb_multihead_attention",
                       [c.c_int] * 5 + [c.c_double, c.c_char_p]),
                      ("ffgb_scalar", [c.c_int, c.c_char_p, c.c_double,
                                       c.c_int, c.c_char_p]),
                      ("ffgb_transpose", [c.c_int, ip, c.c_int, c.c_char_p]),
                      ("ffgb_mean", [c.c_int, ip, c.c_int, c.c_int,
                                     c.c_char_p]),
                      ("ffgb_cast", [c.c_int, c.c_char_p, c.c_char_p]),
                      ("ffgb_output", [ip, c.c_int]),
                      ("ffgb_save", [c.c_char_p]),
                      ("ffgb_serialize", [c.c_char_p, c.c_int])):
        f = getattr(lib, fn)
        f.restype = c.c_int
        f.argtypes = [c.c_void_p] + extra


def native_available() -> bool:
    """Whether the native library builds and loads here (the JAX
    package's name; there a library that cannot build means the Python
    paths, here ``load_native`` raises and this answers False)."""
    try:
        load_native()
    except NativeBuildError:
        return False
    return True


def load_native() -> ctypes.CDLL:
    """Build (if needed) and load the tokenizer, scheduler and graph
    builder library.
    Raises NativeBuildError when it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_native_library())
            _declare(lib)
            _lib = lib
        return _lib
