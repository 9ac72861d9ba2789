"""Build and load the native CIDEr-D scorer (``csrc/cider_d.cpp``).

The C++ compiler (``$CXX``, default ``g++``) builds the source into
``build/native/libciderd.so`` under the checkout root (a directory
``.gitignore`` lists), never next to the source: at the first use of the
library, or ahead of it through ``build()``. The install is atomic (a
per-process temporary file, then ``os.replace``), so concurrent builds
agree. ``-ffp-contract=off`` keeps the compiler from fusing a*b+c, so the
native and NumPy engines agree to float64 rounding whatever the toolchain.

Where no compiler is found, ``load_library(required=False)`` warns and
returns None (``CiderD(backend="auto")`` then scores with NumPy), and
``load_library(required=True)`` raises. A compile that fails raises in
both cases: the source is the repository's own.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parents[1] / "csrc" / "cider_d.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB = BUILD_DIR / "libciderd.so"
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_loaded: dict = {}


def compiler() -> Optional[str]:
    """Path of the C++ compiler, or None."""
    return shutil.which(os.environ.get("CXX", "g++"))


def build() -> str:
    """Compile the source into ``LIB``; returns the compiler's output.
    Raises RuntimeError when no compiler is found or the compile fails."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) found: the native "
                           "CIDEr-D scorer cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libciderd.{os.getpid()}.{threading.get_ident()}.tmp.so"
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native CIDEr-D build failed ({cxx}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, LIB)
    return proc.stdout + proc.stderr


def _fresh() -> bool:
    """The library exists and is newer than its source and this builder."""
    return LIB.exists() and LIB.stat().st_mtime >= max(
        SRC.stat().st_mtime, Path(__file__).stat().st_mtime)


def _configure(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.cider_init.restype = ctypes.c_void_p
    lib.cider_init.argtypes = [i64p, f64p, ctypes.c_int64, ctypes.c_double, ctypes.c_int,
                               ctypes.c_double]
    lib.cider_free.restype = None
    lib.cider_free.argtypes = [ctypes.c_void_p]
    lib.cider_score.restype = None
    lib.cider_score.argtypes = [
        ctypes.c_void_p,
        i32p, i64p, ctypes.c_int64,
        i32p, i64p, ctypes.c_int64,
        i64p, ctypes.c_int64, i64p,
        f64p, ctypes.c_int,
    ]


def load_library(required: bool) -> Optional[ctypes.CDLL]:
    """The loaded, configured library, built on first use; see the module
    docstring for what happens without a compiler."""
    with _lock:
        lib = _loaded.get("lib")
        if lib is None:
            if not _fresh():
                if compiler() is None:
                    if required:
                        raise RuntimeError(
                            "native CIDEr-D backend unavailable: no C++ compiler "
                            "(g++ or $CXX) to build csrc/cider_d.cpp")
                    warnings.warn("no C++ compiler found: CIDEr-D scores with its "
                                  "NumPy engine")
                    return None
                build()
            lib = ctypes.CDLL(str(LIB))
            _configure(lib)
            _loaded["lib"] = lib
        return lib
