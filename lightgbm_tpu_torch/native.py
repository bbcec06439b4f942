"""ctypes binding to the repository's native text loader (src/native/loader.cpp).

Counterpart of lightgbm_tpu/native.py.  The loader tokenizes CSV, TSV and
LibSVM files into a dense float64 matrix with OpenMP (reference:
src/io/parser.cpp, TextReader).  It is compiled with g++ at first use into
its own shared library under build/, named by a hash of the source and the
flags (as ops/cuda_build.py names the kernels' libraries), so an edit
rebuilds and the JAX package's own library next to the source is never
touched.

No fallback: where the build or a parse fails this module raises, as the
kernel wrappers do (the JAX package logs and parses with numpy instead).
io/parser.py::parse_text is the plain numpy parser the tests compare the
native one against.

``c_api_library()`` builds the port's C API (csrc/capi/: the reference's
``LGBM_*`` entry points, forwarding to capi_helpers.py through an embedded
CPython) against the running interpreter's headers and libpython, into
build/ under the same hash naming; load it with ``ctypes.CDLL``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src" / "native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
FLAGS = ["-O3", "-fPIC", "-shared", "-fopenmp", "-std=c++17"]
CAPI_SRC = Path(__file__).resolve().parent / "csrc" / "capi" / "lightgbm_tpu_torch_c_api.cpp"
CAPI_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_FORMAT_CODE = {"auto": -1, "csv": 0, "tsv": 1, "libsvm": 2}

_lock = threading.Lock()
_lib = None


def _target(name: str, files, flags) -> Path:
    """The shared library these sources and flags build to."""
    h = hashlib.sha256()
    for f in files:
        h.update(f.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def target() -> Path:
    """The loader library this source and these flags build to."""
    return _target("loader", [SRC], FLAGS)


def _build(out: Path, src: Path, flags, link=()) -> None:
    """g++ into a temporary file renamed over ``out``: builds that race
    (several test workers) each write their own and the last rename wins."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    r = subprocess.run(["g++", *flags, str(src), "-o", str(tmp), *link],  # jaxlint: disable=L2 (the one-time build: callers that race must wait for it; the lock guards nothing else)
                       capture_output=True, text=True, timeout=240)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {src.name} ({r.returncode}):\n"
                           + (r.stderr or "")[-4000:])
    os.replace(tmp, out)  # jaxlint: disable=L2 (the one-time build's publish, under the same build lock)


def libpython_link() -> list:
    """g++ flags that link the running interpreter's libpython (the rpath
    finds it at load): the C API library embeds it, and so does a C host."""
    libdir = sysconfig.get_config_var("LIBDIR")
    pylib = "python" + sysconfig.get_config_var("py_version_short") + (
        sysconfig.get_config_var("ABIFLAGS") or "")
    return ["-L" + libdir, "-l" + pylib, "-Wl,-rpath," + libdir]


def c_api_library() -> str:
    """The path of the port's C API library, built with g++ on first use
    against the running interpreter's headers and libpython; raises where
    it cannot be built."""
    flags = [*CAPI_FLAGS, "-I" + sysconfig.get_paths()["include"]]
    link = libpython_link()
    with _lock:
        out = _target("lightgbm_tpu_torch_c_api", [CAPI_SRC, CAPI_SRC.with_suffix(".h")],
                      flags + link)
        if not out.is_file():
            _build(out, CAPI_SRC, flags, link)
    return str(out)


def lib() -> ctypes.CDLL:
    """The loader library, built on first use; raises where it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            out = target()
            if not out.is_file():
                _build(out, SRC, FLAGS)
            cdll = ctypes.CDLL(str(out))
            dp = ctypes.POINTER(ctypes.c_double)
            cdll.lgbmtpu_parse_file.restype = ctypes.c_int
            cdll.lgbmtpu_parse_file.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(dp), ctypes.POINTER(dp),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
            cdll.lgbmtpu_free.argtypes = [dp]
            _lib = cdll
    return _lib


def parse_file(path: str, fmt: str = "auto", has_header: bool = False,
               label_idx: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a text file: (data (N, F) float64, label (N,)).  ``label_idx``
    -1 keeps every delimited column in ``data``.  Raises on a file the
    loader cannot read (1: cannot open, 2: empty, 3: out of memory)."""
    cdll = lib()
    dp = ctypes.POINTER(ctypes.c_double)
    pd, pl = dp(), dp()
    n, f = ctypes.c_int64(), ctypes.c_int64()
    rc = cdll.lgbmtpu_parse_file(
        os.fsencode(path), _FORMAT_CODE[fmt], int(has_header), int(label_idx),
        ctypes.byref(pd), ctypes.byref(pl), ctypes.byref(n), ctypes.byref(f))
    if rc != 0:
        raise RuntimeError(f"native loader could not parse {path} (code {rc})")
    try:
        data = np.ctypeslib.as_array(pd, shape=(n.value, f.value)).copy()
        label = np.ctypeslib.as_array(pl, shape=(n.value,)).copy()
    finally:
        cdll.lgbmtpu_free(pd)
        cdll.lgbmtpu_free(pl)
    return data, label
