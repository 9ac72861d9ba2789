"""Build and load the port's host C++ libraries (``csrc/*.cpp``).

Counterpart of ``recurrent_fusion_network_tpu/utils/native_build.py``: the
one lifecycle the native CIDEr-D scorer (``rewards/native.py``) and the
feature-row gather (``data/native.py``) share.

  * The C++ compiler (``$CXX``, default ``g++``) builds the source into
    ``build/native/lib<name>.so`` under the checkout root (a directory
    ``.gitignore`` lists), never next to the source, at the first use of
    the library or ahead of it through ``build()``.
  * The library is rebuilt when the source or this module is newer than
    it, so a change of the flags below reaches every built library.
  * The install is atomic (a per-process temporary file, then
    ``os.replace``): concurrent builds agree, and a build cut short leaves
    no truncated library behind.
  * ``-ffp-contract=off`` keeps the compiler from fusing a*b+c, so a native
    engine and its NumPy fallback agree whatever the toolchain.
  * Where no compiler is found, ``load(required=False)`` warns and returns
    None (the caller's fallback) and ``load(required=True)`` raises. A
    compile that fails raises in both cases: the source is the repository's
    own.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Callable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17", "-pthread")


def compiler() -> Optional[str]:
    """Path of the C++ compiler, or None."""
    return shutil.which(os.environ.get("CXX", "g++"))


class NativeLibrary:
    """``csrc/<source>`` as ``build/native/lib<name>.so``: built on first use,
    loaded and configured (``configure(lib)`` sets the ctypes signatures)
    once per process. ``what`` names the library in errors; ``fallback``
    says in the warning what the caller does without it."""

    def __init__(self, name: str, source: str, configure: Callable[[ctypes.CDLL], None], *,
                 what: str, fallback: str):
        self.src = CSRC / source
        self.path = BUILD_DIR / f"lib{name}.so"
        self.configure, self.what, self.fallback = configure, what, fallback
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def fresh(self) -> bool:
        """The library exists and is newer than its source and this module."""
        return self.path.exists() and self.path.stat().st_mtime >= max(
            self.src.stat().st_mtime, Path(__file__).stat().st_mtime)

    def build(self) -> str:
        """Compile the source into ``path``; returns the compiler's output.
        Raises RuntimeError when no compiler is found or the compile fails."""
        cxx = compiler()
        if cxx is None:
            raise RuntimeError(f"no C++ compiler (g++ or $CXX) found: {self.what} cannot "
                               "be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{self.path.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so"
        proc = subprocess.run([cxx, *CXX_FLAGS, str(self.src), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{self.what}: build failed ({cxx}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, self.path)
        return proc.stdout + proc.stderr

    def load(self, required: bool) -> Optional[ctypes.CDLL]:
        """The loaded, configured library, built on first use; see the
        module docstring for what happens without a compiler."""
        with self._lock:
            if self._lib is None:
                if not self.fresh():
                    if compiler() is None:
                        if required:
                            raise RuntimeError(
                                f"{self.what} unavailable: no C++ compiler (g++ or $CXX) "
                                f"to build csrc/{self.src.name}")
                        warnings.warn(f"no C++ compiler found: {self.fallback}")
                        return None
                    self.build()
                lib = ctypes.CDLL(str(self.path))
                self.configure(lib)
                self._lib = lib
            return self._lib
