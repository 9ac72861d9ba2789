"""The native feature-row gather (``csrc/feature_io.cpp``), built and loaded
through ``utils/native_build.py`` into ``build/native/libfeatureio.so``.

Counterpart of ``recurrent_fusion_network_tpu/data/native/build.py``, with
the same ctypes signature:
``gather_rows(path, offsets, n, row_bytes, out, n_threads) -> 0 | -errno``.
``load_library()`` warns and returns None where no C++ compiler is found
(``data/sharded.py`` then reads through numpy memory maps);
``load_library(required=True)`` raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

from ..utils.native_build import NativeLibrary


def _configure(lib: ctypes.CDLL) -> None:
    lib.gather_rows.restype = ctypes.c_int
    lib.gather_rows.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int,
    ]


LIBRARY = NativeLibrary("featureio", "feature_io.cpp", _configure,
                        what="the native feature gather",
                        fallback="the sharded feature store reads through numpy memory maps")
build = LIBRARY.build


def load_library(required: bool = False) -> Optional[ctypes.CDLL]:
    return LIBRARY.load(required)
