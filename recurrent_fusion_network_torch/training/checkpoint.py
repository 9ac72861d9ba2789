"""Read checkpoints written by the JAX package.

Counterpart of the load half of
``recurrent_fusion_network_tpu/training/checkpoint.py``, which writes per
tag ``{prefix}model_{id}_{rank}[-best].pkl`` (the params tree as numpy
arrays) and ``{prefix}infos_{id}_{rank}[-best].pkl`` (opt snapshot, vocab,
histories). Both are read with an unpickler that admits only numpy,
ml_dtypes and builtin containers, plus the JAX package's ``EncoderInfo``,
which it rebuilds as the port's own copy: loading never imports the JAX
package. The optimizer file holds optax state and is not read here; it
comes with the training slice.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Tuple

from ..feat_registry import EncoderInfo
from ..ops.initializers import tree_map

_ALLOWED_MODULES = ("numpy", "ml_dtypes", "collections")
_REDIRECT = {
    ("recurrent_fusion_network_tpu.feat_registry", "EncoderInfo"): EncoderInfo,
}
_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "slice", "complex",
             "bytearray", "range"}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _REDIRECT:
            return _REDIRECT[(module, name)]
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        if module.split(".")[0] in _ALLOWED_MODULES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint references {module}.{name}, which the port does not load")


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def load_checkpoint(checkpoint_path: str, run_id: str, rank: int = 0, *,
                    best: bool = True, prefix: str = "") -> Tuple[Any, dict]:
    """Returns (params tree of numpy arrays, infos or {})."""
    tag = f"{prefix}{{kind}}_{run_id}_{rank}" + ("-best" if best else "")
    model = os.path.join(checkpoint_path, tag.format(kind="model") + ".pkl")
    if not os.path.exists(model):
        raise FileNotFoundError(model)
    infos = os.path.join(checkpoint_path, tag.format(kind="infos") + ".pkl")
    return (_load_pickle(model),
            _load_pickle(infos) if os.path.exists(infos) else {})


def cast_tree(tree, dtype):
    """Cast every floating leaf of a tensor tree (bf16 inference casting);
    other leaves pass through."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
