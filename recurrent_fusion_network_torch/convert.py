"""JAX params tree (as numpy arrays) -> the port's parameter tree.

The port keeps the JAX package's layout at its public functions, so a
converted tree is the same tree with torch leaves:
  * a linear layer is ``{"w": (in, out), "b": (out,)}`` applied as
    ``x @ w + b`` (the transpose of ``nn.Linear.weight``);
  * untied review steps are stacked on a leading step axis (``review1[j]``:
    R0, ``review2``: S), and stage-II heads on M after it;
  * ``review1_keys`` / ``review2_keys`` exist only in the tied-keys profile
    and ``value_proj`` only under ``low_rank_ctx``.
``check_params`` holds a converted tree against the model's own layout, so
a checkpoint of another architecture fails with the path that differs.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.initializers import tree_map


def _to_tensor(x) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: reinterpret the bits
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    if arr.dtype.kind not in "fiub":
        raise TypeError(f"unsupported parameter leaf dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(tree):
    """Nested dict / list / tuple tree of numpy arrays -> the same tree of
    CPU torch tensors (copies; dtypes kept)."""
    return tree_map(_to_tensor, tree)


def check_params(model, params) -> None:
    """Raise ValueError where ``params`` differs from ``model``'s layout
    (missing or extra entries, shapes)."""
    ref = model.init_params(None, device="meta")  # shapes only, no storage

    def walk(r, p, path):
        if isinstance(r, dict):
            if not isinstance(p, dict) or set(r) != set(p):
                got = sorted(p) if isinstance(p, dict) else type(p).__name__
                raise ValueError(f"params{path}: expected keys {sorted(r)}, got {got}")
            for k in r:
                walk(r[k], p[k], f"{path}[{k!r}]")
        elif isinstance(r, (list, tuple)):
            if not isinstance(p, (list, tuple)) or len(r) != len(p):
                raise ValueError(f"params{path}: expected {len(r)} entries")
            for i, (a, b) in enumerate(zip(r, p)):
                walk(a, b, f"{path}[{i}]")
        elif tuple(r.shape) != tuple(p.shape):
            raise ValueError(
                f"params{path}: expected shape {tuple(r.shape)}, got {tuple(p.shape)}")

    walk(ref, params, "")
