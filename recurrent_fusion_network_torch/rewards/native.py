"""The native CIDEr-D scorer (``csrc/cider_d.cpp``), built and loaded
through ``utils/native_build.py`` into ``build/native/libciderd.so``.

``load_library(required=False)`` warns and returns None where no C++
compiler is found (``CiderD(backend="auto")`` then scores with NumPy);
``load_library(required=True)`` raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

from ..utils.native_build import NativeLibrary


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


LIBRARY = NativeLibrary("ciderd", "cider_d.cpp", _configure, what="the native CIDEr-D scorer",
                        fallback="CIDEr-D scores with its NumPy engine")
SRC, LIB = LIBRARY.src, LIBRARY.path
build = LIBRARY.build


def load_library(required: bool) -> Optional[ctypes.CDLL]:
    return LIBRARY.load(required)
