"""``--checkpoint_backend orbax``: checkpoint triples as
``torch.distributed.checkpoint`` (DCP) directories.

Counterpart of ``recurrent_fusion_network_tpu/training/orbax_ckpt.py``,
with the surface of the pickle backend (``checkpoint.py``) and the JAX
backend's file names, so the runbook's probes and ``has_checkpoint`` work
unchanged. Per tag:

  {prefix}model_{id}_{rank}[-best].orbax/      the params (f32 masters)
  {prefix}optimizer_{id}_{rank}[-best].orbax/  the optax chain's moments and counts
  {prefix}infos_{id}_{rank}[-best].pkl         the infos, as the pickle backend writes them

Each directory holds the tree the pickle triple holds (``convert.
params_to_jax`` / ``opt_state_to_jax``), its leaves under DCP's string keys
(the tree path joined by ``/``) and its structure in ``tree.json`` (dicts,
lists, tuples and the optax state classes by their JAX names), so a
directory and a pickle triple of one state load to equal trees, leaf by
leaf, dtypes included.

The JAX package writes orbax / TensorStore directories under these names
and the port writes DCP ones: neither package reads the other's, and the
port says so when it meets an orbax directory. In a process group of
several ranks (a data-parallel run, ``parallel/distributed.py``) a save and
a load are collective over the group's gloo host group: DCP plans them on
every rank and writes each replicated leaf once; rank 0 alone moves
directories and writes the infos, behind a barrier. A directory written by
several ranks loads in one process like any other.

A save writes each directory under ``.tmp`` and renames it over the old
one, then writes the infos, so a crash mid-write leaves the previous
checkpoint whole. ``async_save`` (``--checkpoint_async 1``) returns once DCP
has staged the arrays in host memory; the write goes on in a thread, and
the renames and the infos follow when ``wait_until_finished`` collects it:
before the next save, in ``has_checkpoint`` / ``load_checkpoint`` /
``save_infos``, at the end of every training loop and, as a backstop, at
interpreter exit; a ``link_triple`` meanwhile is queued behind them.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import warnings
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed.checkpoint as dcp

from ..parallel import distributed
from . import checkpoint as _pickle

# every process of a run would take part in a DCP save (it plans
# collectively); the loops ask a backend whether it is collective
collective = True

_TREE = "tree.json"
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt")
_CLASSES = {path: cls for cls, path in _pickle._JAX_NAMES.items()}
_pending: list = []  # (futures, commit) of async saves not yet collected
_atexit_registered = False
# DCP warns at every save and load made outside a process group (an async
# save's in its writer thread); a single-card run has none on purpose
warnings.filterwarnings("ignore", message="torch.distributed is disabled",
                        module=r"torch\.distributed\.checkpoint")


def _dir(checkpoint_path, kind, run_id, rank, best, prefix) -> str:
    tag = f"{prefix}{kind}_{run_id}_{rank}" + ("-best" if best else "")
    return os.path.join(os.path.abspath(checkpoint_path), tag + ".orbax")


def _group():
    """The gloo host group of this process's group, else None (DCP then
    plans in this process alone)."""
    c = distributed.cluster()
    return None if c is None else c.host_group


def _lead() -> bool:
    """Whether this process moves directories and writes the infos."""
    return distributed.rank() == 0


# ------------------------------------------------------------ the tree


def _flatten(tree, path: str, leaves: dict):
    """-> the JSON structure of ``tree``; its leaves into ``leaves`` as
    tensors sharing the arrays' memory, keyed by their path."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        for k in tree:
            if not isinstance(k, str) or "/" in k:
                raise ValueError(f"checkpoint tree key {k!r} at {path or '/'} is not a "
                                 "string without '/'")
        return {"dict": {k: _flatten(v, f"{path}/{k}", leaves) for k, v in tree.items()}}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"class": list(_pickle._JAX_NAMES[type(tree)]),
                "fields": {f: _flatten(getattr(tree, f), f"{path}/{f}", leaves)
                           for f in tree._fields}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_flatten(v, f"{path}/{i}", leaves) for i, v in enumerate(tree)]}
    arr = np.asarray(tree)
    if not arr.flags.c_contiguous:  # (ascontiguousarray would turn a 0-d count 1-d)
        arr = arr.copy()
    key = path.lstrip("/")
    leaves[key] = torch.from_numpy(arr)
    return {"leaf": key}


def _unflatten(node, leaves: dict):
    if node is None:
        return None
    if "dict" in node:
        return {k: _unflatten(v, leaves) for k, v in node["dict"].items()}
    if "class" in node:
        cls = _CLASSES[tuple(node["class"])]
        return cls(**{f: _unflatten(v, leaves) for f, v in node["fields"].items()})
    if "list" in node:
        return [_unflatten(v, leaves) for v in node["list"]]
    if "tuple" in node:
        return tuple(_unflatten(v, leaves) for v in node["tuple"])
    return leaves[node["leaf"]].numpy()


def _write(tree, path: str, async_save: bool):
    """Write ``tree`` as the DCP directory ``path`` (through ``path.tmp``).
    -> (future or None, commit): ``commit()`` adds the structure and
    renames the directory into place once the write is done."""
    tmp = path + ".tmp"
    group = _group()
    if _lead() and os.path.isdir(tmp):
        shutil.rmtree(tmp)
    distributed.barrier()  # no rank writes into a stale directory
    leaves: dict = {}
    structure = _flatten(tree, "", leaves)
    writer = dcp.FileSystemWriter(tmp)
    if async_save:
        future = dcp.async_save(leaves, storage_writer=writer, process_group=group)
    else:
        dcp.save(leaves, storage_writer=writer, process_group=group)
        future = None

    def commit():
        if not _lead():
            return
        with open(os.path.join(tmp, _TREE), "w") as f:
            json.dump(structure, f)
        _replace_dir(tmp, path)

    return future, commit


def _replace_dir(src: str, dst: str) -> None:
    old = dst + ".old"
    if os.path.isdir(old):
        shutil.rmtree(old)
    if os.path.isdir(dst):
        os.rename(dst, old)
    os.rename(src, dst)
    if os.path.isdir(old):
        shutil.rmtree(old)


def _read(path: str):
    if not os.path.exists(os.path.join(path, _TREE)):
        if any(os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
            raise ValueError(
                f"{path} was written by orbax (the JAX package's --checkpoint_backend "
                "orbax); the port writes and reads torch.distributed.checkpoint "
                "directories under the same names, and neither package reads the other's "
                "(use --checkpoint_backend pickle to share checkpoints)")
        raise ValueError(f"{path} is not a checkpoint directory of the port (no {_TREE})")
    with open(os.path.join(path, _TREE)) as f:
        structure = json.load(f)
    reader = dcp.FileSystemReader(path)
    meta = reader.read_metadata().state_dict_metadata
    leaves = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype) for k, m in meta.items()}
    dcp.load(leaves, storage_reader=reader, process_group=_group())
    return _unflatten(structure, leaves)


# ------------------------------------------------------------ the surface


def wait_until_finished() -> None:
    """Collect every async save: wait for its writes, then rename its
    directories into place and write its infos (rank 0; the ranks meet at a
    barrier after). A failed write raises here."""
    global _pending
    pending, _pending = _pending, []
    for futures, commit in pending:
        for future in futures:
            future.result()
        commit()
    if pending:
        distributed.barrier()


def _wait_at_exit() -> None:
    try:
        wait_until_finished()
    except Exception as e:  # the interpreter is going down: say so, do not mask the exit
        print(f"warning: an async checkpoint write failed at exit: {e}")


def save_checkpoint(checkpoint_path: str, run_id: str, rank: int, *, params,
                    opt_state=None, infos: Optional[dict] = None, best: bool = False,
                    prefix: str = "", async_save: bool = False) -> None:
    """The pickle backend's ``save_checkpoint`` as DCP directories.
    ``async_save``: wait for the previous save, stage this one's arrays
    and return while the write runs (``wait_until_finished`` completes
    it). A params-only save retires the tag's optimizer directory."""
    global _atexit_registered
    wait_until_finished()  # one save in flight at a time, in order
    os.makedirs(checkpoint_path, exist_ok=True)
    path = lambda kind: _dir(checkpoint_path, kind, run_id, rank, best, prefix)  # noqa: E731
    writes = [_write(params, path("model"), async_save)]
    if opt_state is not None:
        writes.append(_write(opt_state, path("optimizer"), async_save))

    def commit():
        for _, commit_dir in writes:
            commit_dir()
        if not _lead():
            return
        if opt_state is None and os.path.isdir(path("optimizer")):
            shutil.rmtree(path("optimizer"))  # the triple is a unit
        if infos is not None:
            _pickle.save_infos(checkpoint_path, run_id, rank, infos, best=best, prefix=prefix)

    if not async_save:
        commit()
        distributed.barrier()
        return
    if not _atexit_registered:
        atexit.register(_wait_at_exit)
        _atexit_registered = True
    _pending.append(([f for f, _ in writes], commit))


def save_infos(checkpoint_path: str, run_id: str, rank: int, infos: dict, *, best: bool,
               prefix: str = "") -> None:
    """The infos file of one tag (the pickle backend's file; rank 0's)."""
    wait_until_finished()
    if _lead():
        _pickle.save_infos(checkpoint_path, run_id, rank, infos, best=best, prefix=prefix)


def link_triple(src_dir: str, src_id: str, rank: int, dst_dir: str, dst_id: str, *,
                src_best: bool, dst_best: bool, src_prefix: str = "", dst_prefix: str = "",
                kinds=("model", "optimizer", "infos")) -> None:
    """The pickle backend's ``link_triple`` for DCP directories: each file
    of a source directory hard-linked (or copied) into a fresh destination
    directory, renamed over the old one; a kind the source lacks is removed
    at the destination. Behind async saves in flight it is queued after
    them, so a best boundary does not wait for the rolling triple's
    write. Rank 0 links."""
    def link():
        if _lead():
            _link_triple(src_dir, src_id, rank, dst_dir, dst_id, src_best=src_best,
                         dst_best=dst_best, src_prefix=src_prefix, dst_prefix=dst_prefix,
                         kinds=kinds)

    if _pending:
        _pending.append(([], link))
    else:
        link()


def _link_triple(src_dir, src_id, rank, dst_dir, dst_id, *, src_best, dst_best, src_prefix,
                 dst_prefix, kinds):
    for kind in kinds:
        if kind == "infos":
            _pickle.link_triple(src_dir, src_id, rank, dst_dir, dst_id, src_best=src_best,
                                dst_best=dst_best, src_prefix=src_prefix,
                                dst_prefix=dst_prefix, kinds=("infos",))
            continue
        src = _dir(src_dir, kind, src_id, rank, src_best, src_prefix)
        dst = _dir(dst_dir, kind, dst_id, rank, dst_best, dst_prefix)
        if not os.path.isdir(src):
            if os.path.isdir(dst):
                shutil.rmtree(dst)
            continue
        tmp = dst + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for name in os.listdir(src):
            try:
                os.link(os.path.join(src, name), os.path.join(tmp, name))
            except OSError:
                shutil.copyfile(os.path.join(src, name), os.path.join(tmp, name))
        _replace_dir(tmp, dst)


def has_checkpoint(checkpoint_path: str, run_id: str, rank: int = 0, *,
                   best: bool = True, prefix: str = "") -> bool:
    """Whether the tag's model directory exists, once the writes in flight
    are done (a probe that reads nothing)."""
    wait_until_finished()
    return os.path.isdir(_dir(checkpoint_path, "model", run_id, rank, best, prefix))


def load_checkpoint(checkpoint_path: str, run_id: str, rank: int = 0, *,
                    best: bool = True, prefix: str = "") -> Tuple[Any, dict]:
    """Returns (params tree of numpy arrays, infos or {}), as the pickle
    backend's does."""
    wait_until_finished()
    model = _dir(checkpoint_path, "model", run_id, rank, best, prefix)
    if not os.path.isdir(model):
        raise FileNotFoundError(model)
    infos = _pickle._path(checkpoint_path, "infos", run_id, rank, best, prefix)
    return _read(model), (_pickle._load_pickle(infos) if os.path.exists(infos) else {})


def load_optimizer(checkpoint_path: str, run_id: str, rank: int = 0, *,
                   best: bool = True, prefix: str = ""):
    """The optimizer directory's optax chain state, or None where the tag
    has none."""
    wait_until_finished()
    path = _dir(checkpoint_path, "optimizer", run_id, rank, best, prefix)
    return _read(path) if os.path.isdir(path) else None
