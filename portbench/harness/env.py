"""Process set-up and the run's guards.

* Caches: every build and kernel cache lives at a fixed path inside the
  checkout (``build/``, which ``.gitignore`` lists). The port builds its
  CUDA and C++ libraries into ``build/kernels`` and ``build/native`` by
  itself; Triton, torch extensions and the CUDA JIT cache are pointed there.
* The precision pin: IEEE f32 matmuls (no TF32) for cells whose traffic
  states float32, set before the port is built and read again at the end.
* The look for a chip, and the look for JAX in ``sys.modules``.
"""

from __future__ import annotations

import hashlib
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout
BUILD = ROOT / "build"

# top-level module names that may not be loaded in a run: JAX and the JAX
# package the port was made from (compared whole: the port's own name,
# recurrent_fusion_network_torch, begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "recurrent_fusion_network_tpu")
PORT = "recurrent_fusion_network_torch"


def set_cache_dirs() -> None:
    """Fixed cache directories inside the checkout, so that only the first
    run of a cell in a checkout builds or compiles anything."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = str(BUILD / sub)
    # the port uses no Flax model; keep libraries that could load JAX away
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(modules=None) -> list:
    """The top-level names of ``modules`` (default ``sys.modules``) that
    are JAX or the JAX package, each compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def port_present() -> bool:
    return (ROOT / PORT / "__init__.py").exists()


def sub_seed(seed: int, tag: str) -> int:
    """A seed of 62 bits for one use (``tag``) of the run's ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 2


def pin_ieee_f32(torch) -> None:
    """f32 matmuls and convolutions in IEEE f32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def ieee_f32_pinned(torch) -> bool:
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


def chip_check(torch, chips: int) -> str:
    """'' when this machine has the ``chips`` CUDA cards the cell asks for,
    else why not."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards and {torch.cuda.device_count()} are visible"
    return ""
