"""Checkpoint triples, in the JAX package's format both ways.

Counterpart of ``recurrent_fusion_network_tpu/training/checkpoint.py``
(its pickle backend). Per tag there are three files:
``{prefix}model_{id}_{rank}[-best].pkl`` (the params tree as numpy arrays),
``{prefix}optimizer_{id}_{rank}[-best].pkl`` (the optax chain's state) and
``{prefix}infos_{id}_{rank}[-best].pkl`` (opt snapshot, vocab, histories,
loader state).

Reading admits only numpy, ml_dtypes and builtin containers, plus the JAX
package's ``EncoderInfo`` and optax's state classes, which it rebuilds as
the port's own classes (``convert.py``): loading never imports the JAX
package or optax. Writing pickles those port classes under the JAX
package's and optax's class paths, written by name (``_JaxNamePickler``),
so the JAX package reads a port-written triple as its own: an encoder entry
stays an ``EncoderInfo`` (a plain dict would make its eval score synthetic
features), and the optimizer file is the chain ``opt_state_to_jax`` builds.
The port's infos carry no ``rng_key`` (a JAX key); its own random stream
rides under ``torch_rng_state``. Orbax checkpoints are not ported
(ROADMAP.md queue 1, M11).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional, Tuple

from ..convert import JaxEmptyState, JaxScaleByAdamState, JaxTraceState
from ..feat_registry import EncoderInfo
from ..models.base import resolve_tied
from ..ops.initializers import tree_map

_ALLOWED_MODULES = ("numpy", "ml_dtypes", "collections")
_REDIRECT = {
    ("recurrent_fusion_network_tpu.feat_registry", "EncoderInfo"): EncoderInfo,
    ("optax._src.base", "EmptyState"): JaxEmptyState,
    ("optax._src.transform", "ScaleByAdamState"): JaxScaleByAdamState,
    ("optax._src.transform", "TraceState"): JaxTraceState,  # older optax
    ("optax.transforms._accumulation", "TraceState"): JaxTraceState,
}
# the class paths the port's classes are written under (the installed optax
# keeps TraceState in optax.transforms._accumulation; older ones read it
# from optax._src.transform, see _REDIRECT)
_JAX_NAMES = {
    EncoderInfo: ("recurrent_fusion_network_tpu.feat_registry", "EncoderInfo"),
    JaxEmptyState: ("optax._src.base", "EmptyState"),
    JaxScaleByAdamState: ("optax._src.transform", "ScaleByAdamState"),
    JaxTraceState: ("optax.transforms._accumulation", "TraceState"),
}
_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "slice", "complex",
             "bytearray", "range"}

# opt keys that fix the parameter tree: a resume whose options disagree with
# the checkpoint's saved opt fails on the key (JAX checkpoint.ARCH_KEYS)
ARCH_KEYS = (
    "caption_model", "rnn_type", "rnn_size", "num_layers",
    "input_encoding_size", "att_hid_size", "use_mos",
    "num_review_steps", "num_review_steps_0", "tied_att_keys",
    "low_rank_ctx", "maxout", "review_maxout", "fusion_maxout",
)


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


class _JaxNamePickler(pickle._Pickler):
    """The pure-Python pickler, writing the classes of ``_JAX_NAMES`` by
    their JAX-side names without importing them. The C pickler cannot: it
    writes a class (also one that ``reducer_override`` or ``__reduce__``
    names) only after importing its module and finding that very object
    there. Array data goes to the file as bytes either way."""

    def save_global(self, obj, name=None):
        path = _JAX_NAMES.get(obj)
        if path is None:
            return super().save_global(obj, name)
        self.save(path[0])
        self.save(path[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _path(checkpoint_path, kind, run_id, rank, best, prefix) -> str:
    tag = f"{prefix}{kind}_{run_id}_{rank}" + ("-best" if best else "")
    return os.path.join(checkpoint_path, tag + ".pkl")


def save_checkpoint(checkpoint_path: str, run_id: str, rank: int, *, params,
                    opt_state=None, infos: Optional[dict] = None, best: bool = False,
                    prefix: str = "") -> None:
    """Write the triple of one tag. ``params``: the params tree as numpy
    arrays (``convert.params_to_jax``); ``opt_state``: the optax chain
    (``convert.opt_state_to_jax``) or None; ``infos``: the infos dict. Each
    file is written to ``.tmp`` and renamed over the old one, so a crash
    mid-write never truncates the previous checkpoint. A params-only save
    removes the tag's optimizer file: the triple is a unit, and a stale
    optimizer beside fresh params would resume with the wrong moments."""
    os.makedirs(checkpoint_path, exist_ok=True)

    def dump(kind, obj, pickler):
        path = _path(checkpoint_path, kind, run_id, rank, best, prefix)
        with open(path + ".tmp", "wb") as f:
            pickler(f, protocol=4).dump(obj)
        os.replace(path + ".tmp", path)

    dump("model", params, pickle.Pickler)
    if opt_state is not None:
        dump("optimizer", opt_state, _JaxNamePickler)
    else:
        stale = _path(checkpoint_path, "optimizer", run_id, rank, best, prefix)
        if os.path.exists(stale):
            os.remove(stale)
    if infos is not None:
        dump("infos", infos, _JaxNamePickler)


def has_checkpoint(checkpoint_path: str, run_id: str, rank: int = 0, *,
                   best: bool = True, prefix: str = "") -> bool:
    """Whether the tag's model file exists (a probe that reads nothing)."""
    return os.path.exists(_path(checkpoint_path, "model", run_id, rank, best, prefix))


def load_checkpoint(checkpoint_path: str, run_id: str, rank: int = 0, *,
                    best: bool = True, prefix: str = "") -> Tuple[Any, dict]:
    """Returns (params tree of numpy arrays, infos or {})."""
    model = _path(checkpoint_path, "model", run_id, rank, best, prefix)
    if not os.path.exists(model):
        raise FileNotFoundError(model)
    infos = _path(checkpoint_path, "infos", run_id, rank, best, prefix)
    return (_load_pickle(model),
            _load_pickle(infos) if os.path.exists(infos) else {})


def load_optimizer(checkpoint_path: str, run_id: str, rank: int = 0, *,
                   best: bool = True, prefix: str = ""):
    """The optimizer file's optax chain state (tuple of the port's mirror
    named tuples, numpy leaves), or None where the tag has no such file;
    ``convert.opt_state_from_jax`` turns it into the port's state."""
    path = _path(checkpoint_path, "optimizer", run_id, rank, best, prefix)
    return _load_pickle(path) if os.path.exists(path) else None


def assert_arch_matches(opt, saved_opt: dict) -> None:
    """Raise where ``opt`` and a checkpoint's saved opt disagree on a key
    that fixes the parameter tree (keys the saved opt lacks are skipped)."""
    for key in ARCH_KEYS:
        ours = getattr(opt, key, None)
        if key == "tied_att_keys":
            ours = int(resolve_tied(opt))  # -1 = auto, as the JAX options resolve it
        if key in saved_opt and saved_opt[key] != ours:
            raise ValueError(
                f"command line and saved model disagree on '{key}' (CLI "
                f"{ours!r} vs checkpoint {saved_opt[key]!r})")


def cast_tree(tree, dtype):
    """Cast every floating leaf of a tensor tree (bf16 inference casting);
    other leaves pass through."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
