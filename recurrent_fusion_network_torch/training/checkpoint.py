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
rides under ``torch_rng_state``.

``backend(opt)`` picks this module or, for ``--checkpoint_backend orbax``,
``orbax_ckpt`` (``torch.distributed.checkpoint`` directories under the JAX
backend's names); both have the same surface. In a data-parallel run rank 0
alone writes pickle triples (``writes_here``), and the ranks meet at a
barrier after each boundary's writes (``train_loop.Boundaries``).
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Any, Optional, Tuple

from ..convert import (JaxEmptyState, JaxScaleByAdaDeltaState, JaxScaleByAdagradState,
                       JaxScaleByAdamState, JaxScaleByRmsState, JaxTraceState)
from ..feat_registry import EncoderInfo
from ..models.base import resolve_tied
from ..ops.initializers import tree_map

# a pickle save is one process's file write (the orbax backend's is
# collective); the loops ask a backend which it is
collective = False


def backend(opt):
    """The checkpoint module of ``opt.checkpoint_backend``: this one
    ('pickle', the reference's triple files) or ``orbax_ckpt`` ('orbax');
    with ``--checkpoint_async 1`` the latter's saves run in the
    background."""
    import sys

    if getattr(opt, "checkpoint_backend", "pickle") != "orbax":
        return sys.modules[__name__]
    from . import orbax_ckpt

    if not getattr(opt, "checkpoint_async", 0):
        return orbax_ckpt
    import functools
    import types

    return types.SimpleNamespace(
        **{k: getattr(orbax_ckpt, k) for k in ("load_checkpoint", "load_optimizer",
                                                "has_checkpoint", "save_infos", "link_triple",
                                                "wait_until_finished", "collective")},
        save_checkpoint=functools.partial(orbax_ckpt.save_checkpoint, async_save=True))


def wait_until_finished() -> None:
    """Nothing to wait for: pickle saves are done when they return."""


def writes_here(ckpt) -> bool:
    """Whether this process writes a data-parallel run's triples through
    the backend ``ckpt``: every rank for a collective one (DCP plans each
    save over the group), rank 0 alone for pickle files (the ranks hold the
    same parameters, and one writer keeps them off each other's files)."""
    from ..parallel.distributed import rank

    return ckpt.collective or rank() == 0


_ALLOWED_MODULES = ("numpy", "ml_dtypes", "collections")
_REDIRECT = {
    ("recurrent_fusion_network_tpu.feat_registry", "EncoderInfo"): EncoderInfo,
    ("optax._src.base", "EmptyState"): JaxEmptyState,
    ("optax._src.transform", "ScaleByAdamState"): JaxScaleByAdamState,
    ("optax._src.transform", "TraceState"): JaxTraceState,  # older optax
    ("optax.transforms._accumulation", "TraceState"): JaxTraceState,
    ("optax._src.transform", "ScaleByRmsState"): JaxScaleByRmsState,
    ("optax._src.transform", "ScaleByAdaDeltaState"): JaxScaleByAdaDeltaState,
    ("recurrent_fusion_network_tpu.training.optim", "ScaleByAdagradState"):
        JaxScaleByAdagradState,
}
# the class paths the port's classes are written under (the installed optax
# keeps TraceState in optax.transforms._accumulation; older ones read it
# from optax._src.transform, see _REDIRECT)
_JAX_NAMES = {
    EncoderInfo: ("recurrent_fusion_network_tpu.feat_registry", "EncoderInfo"),
    JaxEmptyState: ("optax._src.base", "EmptyState"),
    JaxScaleByAdamState: ("optax._src.transform", "ScaleByAdamState"),
    JaxTraceState: ("optax.transforms._accumulation", "TraceState"),
    JaxScaleByRmsState: ("optax._src.transform", "ScaleByRmsState"),
    JaxScaleByAdaDeltaState: ("optax._src.transform", "ScaleByAdaDeltaState"),
    JaxScaleByAdagradState: ("recurrent_fusion_network_tpu.training.optim",
                             "ScaleByAdagradState"),
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
    path = lambda kind: _path(checkpoint_path, kind, run_id, rank, best, prefix)  # noqa: E731
    _dump(path("model"), params, pickle.Pickler)
    if opt_state is not None:
        _dump(path("optimizer"), opt_state, _JaxNamePickler)
    elif os.path.exists(path("optimizer")):
        os.remove(path("optimizer"))
    if infos is not None:
        save_infos(checkpoint_path, run_id, rank, infos, best=best, prefix=prefix)


def _dump(path, obj, pickler):
    with open(path + ".tmp", "wb") as f:
        pickler(f, protocol=4).dump(obj)
    os.replace(path + ".tmp", path)


def save_infos(checkpoint_path: str, run_id: str, rank: int, infos: dict, *, best: bool,
               prefix: str = "") -> None:
    """Write the infos file of one tag (``.tmp``, then renamed)."""
    os.makedirs(checkpoint_path, exist_ok=True)
    _dump(_path(checkpoint_path, "infos", run_id, rank, best, prefix), infos, _JaxNamePickler)


def link_triple(src_dir: str, src_id: str, rank: int, dst_dir: str, dst_id: str, *,
                src_best: bool, dst_best: bool, src_prefix: str = "", dst_prefix: str = "",
                kinds=("model", "optimizer", "infos")) -> None:
    """Give one tag's files (of ``kinds``) the names of another tag as hard
    links, or copies where the file system has none: the same bytes, not
    written again. A kind the source tag lacks is removed at the
    destination (a triple is a unit). Each name is linked to ``.tmp`` and
    renamed over the old file, and a later write of either tag renames a
    new file over its own name, so the other keeps its bytes."""
    os.makedirs(dst_dir, exist_ok=True)
    for kind in kinds:
        src = _path(src_dir, kind, src_id, rank, src_best, src_prefix)
        dst = _path(dst_dir, kind, dst_id, rank, dst_best, dst_prefix)
        if not os.path.exists(src):
            if os.path.exists(dst):
                os.remove(dst)
            continue
        if os.path.exists(dst + ".tmp"):
            os.remove(dst + ".tmp")
        try:
            os.link(src, dst + ".tmp")
        except OSError:
            shutil.copyfile(src, dst + ".tmp")
        os.replace(dst + ".tmp", dst)


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
    return _load_pickle(model), load_infos(checkpoint_path, run_id, rank, best=best,
                                           prefix=prefix)


def load_infos(checkpoint_path: str, run_id: str, rank: int = 0, *,
               best: bool = True, prefix: str = "") -> dict:
    """The tag's infos alone (no params read), or {} where it has none."""
    infos = _path(checkpoint_path, "infos", run_id, rank, best, prefix)
    return _load_pickle(infos) if os.path.exists(infos) else {}


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
