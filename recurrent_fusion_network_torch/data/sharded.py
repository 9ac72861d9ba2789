"""Sharded columnar feature store.

The port's copy of ``recurrent_fusion_network_tpu/data/sharded.py``; the
files are the same byte for byte, so either package reads a store the
other wrote. ``PackedFeatureSource`` (dataset.py) keeps one memory-mapped
array per variant; this store splits the rows into fixed-size shards, each
one binary file laid out variant-major and column-major:

  root/
    manifest.json        version 1; ids (global row order), fc_dim,
                         att_num, att_dim, variants (sorted), shard_size,
                         per-shard file name and row count
    shard-00000.bin      for each variant v, in manifest order:
    shard-00001.bin        [fc block:  count x D      f32]
    ...                    [att block: count x A x C  f32]

A batch read groups its rows by (shard, variant) and reads each group's fc
and att rows with one call of the native gather (``data/native.py``:
positioned reads fanned over a thread pool, without the GIL), or, where no
C++ compiler is found, through numpy memory maps. ``engine`` says which,
``native_gathers`` counts the native calls, and ``shards_opened`` counts the
shard files touched (a loader reads only the shards its rows live in).
Layout mismatches raise ValueError (not assert: the checks must hold under
``python -O``).
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_F32 = 4  # bytes


class ShardedFeatureSource:
    """Reader over a sharded columnar feature store (see the module
    docstring).

    load(image_id, variant)         -> (fc (D,), att (A, C))
    load_batch(image_ids, variants) -> (fc (n, D), att (n, A, C))
    """

    def __init__(self, root: str, *, use_native: bool = True, io_threads: int = 8):
        self.root = root
        with open(os.path.join(root, "manifest.json")) as f:
            m = json.load(f)
        if m.get("version") != 1:
            raise ValueError(f"unknown store version {m.get('version')}")
        self.fc_dim: int = m["fc_dim"]
        self.att_num: int = m["att_num"]
        self.att_dim: int = m["att_dim"]
        self.variants: List[str] = m["variants"]
        self._variant_ix = {v: i for i, v in enumerate(self.variants)}
        self.shard_size: int = m["shard_size"]
        self.shards: List[dict] = m["shards"]
        self.ids: List = m["ids"]
        # rows map to shards by r // shard_size, while the offsets trust the
        # per-shard counts: they agree only when every shard but the last
        # holds shard_size rows and the counts add up to the ids
        counts = [int(s["count"]) for s in self.shards]
        if any(c != self.shard_size for c in counts[:-1]) or (
                counts and not 0 < counts[-1] <= self.shard_size) or sum(counts) != len(self.ids):
            raise ValueError(f"inconsistent manifest: shard counts {counts} vs shard_size "
                             f"{self.shard_size} and {len(self.ids)} ids")
        self.row: Dict = {image_id: r for r, image_id in enumerate(self.ids)}
        self.io_threads = io_threads
        self._lib = None
        if use_native:
            from .native import load_library

            self._lib = load_library()
        self.engine = "memmap" if self._lib is None else "native"
        self.native_gathers = 0
        self._mmaps: Dict[int, np.ndarray] = {}
        self._seen_shards: set = set()

    @property
    def shards_opened(self) -> int:
        return len(self._seen_shards)

    # -------------------------------------------------------------- geometry

    def _locate(self, image_id) -> Tuple[int, int]:
        r = self.row[image_id]
        return r // self.shard_size, r % self.shard_size

    def _offsets(self, shard: int, vi: int) -> Tuple[int, int]:
        """(fc block start, att block start), byte offsets in the shard."""
        c = self.shards[shard]["count"]
        base = vi * c * (self.fc_dim + self.att_num * self.att_dim) * _F32
        return base, base + c * self.fc_dim * _F32

    def _path(self, shard: int) -> str:
        return os.path.join(self.root, self.shards[shard]["file"])

    # ----------------------------------------------------------------- reads

    def load(self, image_id, variant: str = "original"):
        fc, att = self.load_batch([image_id], [variant])
        return fc[0], att[0]

    def load_batch(self, image_ids: Sequence, variants: Optional[Sequence[str]] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        n = len(image_ids)
        if variants is None:
            variants = ["original"] * n
        if len(variants) != n:
            raise ValueError(f"{len(variants)} variants for {n} image ids")
        D, A, C = self.fc_dim, self.att_num, self.att_dim
        fc_out = np.empty((n, D), np.float32)
        att_out = np.empty((n, A, C), np.float32)
        groups: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
        for i, (image_id, v) in enumerate(zip(image_ids, variants)):
            shard, local = self._locate(image_id)
            groups.setdefault((shard, self._variant_ix[v]), []).append((i, local))
        for (shard, vi), members in groups.items():
            idx = np.array([m[0] for m in members])
            local = np.array([m[1] for m in members], np.int64)
            fc_base, att_base = self._offsets(shard, vi)
            fc_out[idx] = self._rows(shard, fc_base + local * (D * _F32), D).reshape(-1, D)
            att_out[idx] = self._rows(shard, att_base + local * (A * C * _F32),
                                      A * C).reshape(-1, A, C)
        return fc_out, att_out

    def _rows(self, shard: int, offsets: np.ndarray, width: int) -> np.ndarray:
        """The f32 rows of ``width`` values at byte ``offsets`` of a shard,
        -> (n * width,)."""
        self._seen_shards.add(shard)
        if self._lib is None:
            mm = self._mmap(shard)
            return np.concatenate([mm[o // _F32: o // _F32 + width] for o in offsets])
        out = np.empty(len(offsets) * width, np.float32)
        offsets = np.ascontiguousarray(offsets, np.int64)
        rc = self._lib.gather_rows(
            self._path(shard).encode(), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(offsets), width * _F32, out.ctypes.data_as(ctypes.c_char_p), self.io_threads)
        if rc != 0:
            raise OSError(-rc, f"gather_rows failed on {self._path(shard)}")
        self.native_gathers += 1
        return out

    def _mmap(self, shard: int) -> np.ndarray:
        if shard not in self._mmaps:
            self._mmaps[shard] = np.memmap(self._path(shard), dtype=np.float32, mode="r")
        return self._mmaps[shard]

    # ---------------------------------------------------------------- writer

    @staticmethod
    def write(root: str, ids: Sequence, fc_by_variant: Dict[str, np.ndarray],
              att_by_variant: Dict[str, np.ndarray], *, shard_size: int = 4096
              ) -> "ShardedFeatureSource":
        """Create a store from (N, D) fc and (N, A, C) att arrays per variant
        (the same variants; rows in ``ids`` order)."""
        variants = sorted(fc_by_variant)
        if sorted(att_by_variant) != variants:
            raise ValueError("fc/att variant sets differ")
        n = len(ids)
        fc0, att0 = fc_by_variant[variants[0]], att_by_variant[variants[0]]
        if fc0.shape[0] != n or att0.shape[0] != n:
            raise ValueError(f"row counts {fc0.shape[0]}/{att0.shape[0]} != len(ids) {n}")
        D, (A, C) = fc0.shape[1], att0.shape[1:]
        os.makedirs(root, exist_ok=True)
        shards = []
        for s, lo in enumerate(range(0, n, shard_size)):
            hi = min(lo + shard_size, n)
            name = f"shard-{s:05d}.bin"
            with open(os.path.join(root, name), "wb") as f:
                for v in variants:
                    fc = np.ascontiguousarray(fc_by_variant[v][lo:hi], np.float32)
                    att = np.ascontiguousarray(att_by_variant[v][lo:hi], np.float32)
                    if fc.shape != (hi - lo, D) or att.shape != (hi - lo, A, C):
                        raise ValueError(
                            f"variant '{v}' rows [{lo}:{hi}] have shapes {fc.shape}/"
                            f"{att.shape}, want {(hi - lo, D)}/{(hi - lo, A, C)}")
                    f.write(fc.tobytes())
                    f.write(att.tobytes())
            shards.append({"file": name, "count": hi - lo})
        manifest = {"version": 1, "fc_dim": int(D), "att_num": int(A), "att_dim": int(C),
                    "variants": variants, "shard_size": int(shard_size), "shards": shards,
                    "ids": list(ids)}
        with open(os.path.join(root, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        return ShardedFeatureSource(root)


def pack_to_shards(packed_root: str, out_root: str, *, shard_size: int = 4096
                   ) -> ShardedFeatureSource:
    """Convert a ``PackedFeatureSource`` directory into a sharded store."""
    from .dataset import PackedFeatureSource

    src = PackedFeatureSource(packed_root)
    ids = [None] * len(src.row)
    for image_id, r in src.row.items():
        ids[r] = image_id
    variants = sorted(f[: -len("_fc.npy")] for f in os.listdir(packed_root)
                      if f.endswith("_fc.npy"))
    arrays = {v: src._arrays(v) for v in variants}
    return ShardedFeatureSource.write(
        out_root, ids, {v: a[0] for v, a in arrays.items()},
        {v: a[1] for v, a in arrays.items()}, shard_size=shard_size)
