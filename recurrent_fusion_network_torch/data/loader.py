"""Training-time DataLoader.

The port's copy of ``recurrent_fusion_network_tpu/data/loader.py``, with
the same batch dict contract as the reference's ``DataLoader.get_batch``
(dataloader.py:221-356):

  fc_feats / att_feats            (single-encoder) or
  fc_feats_array / att_feats_array (several encoders: lists of M arrays)
  labels   (B*seq_per_img, L+2)   zero-bordered token matrix
  masks    (B*seq_per_img, L+2)   1s through EOS+1
  gts      list of (ncap, L) full caption sets per image (reward eval)
  top_words(B*seq_per_img, top_words_count) -1-padded top-word ids
  infos    per-image {ix, id, file_path}
  bounds   {it_pos_now, it_max, wrapped}

A double-buffered background-thread prefetcher assembles whole batches,
with iterator and RNG state snapshotted per batch so checkpoint / resume
stays exact; the same seed gives the JAX package's batches. Batch assembly
writes the feature arrays into a staging ring (``data/pinned.py``):
page-locked buffers when ``opt.device`` is CUDA, ordinary memory on the
CPU. Once ``device_batch`` has copied a batch to the card, its feature
arrays belong to the loader again. With ``host_shard=(rank, world)`` a
data-parallel rank walks the global stream and materialises only its block
of each global batch, as the JAX loader does per host.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np

from ..device import resolve_device
from ..utils.profiling import span
from .dataset import FLIP_TYPE_TO_VARIANT, Dataset
from .pinned import PinnedRing


def _as_py_rng_state(state):
    """random.Random.setstate needs (version, tuple_of_ints, gauss_next);
    pickle preserves the tuples, but states that round-tripped through a
    list-producing serializer still restore."""
    version, internal, gauss_next = state
    return (version, tuple(internal), gauss_next)


class DataLoader:
    def __init__(
        self,
        opt,
        dataset: Dataset,
        sources: Sequence,  # one FeatureSource per encoder
        *,
        prefetch: bool = True,
        host_shard: tuple = (0, 1),
    ):
        self.opt = opt
        self.dataset = dataset
        self.sources = list(sources)
        self.num_feat_array = len(self.sources)
        self.feature_type = opt.feature_type
        # data-parallel input sharding: (rank, world). Every rank walks the
        # SAME global image stream (identical cursors, shuffle and
        # augmentation draws), but materialises features and labels only
        # for its contiguous block of the global batch
        self.host_index, self.host_count = host_shard
        # split -> staging buffers, page-locked for a copy to the card
        pin = resolve_device(opt.device).type == "cuda"
        self._staging = {s: PinnedRing(pin=pin) for s in ("train", "val", "test")}
        self._pool = ThreadPoolExecutor(4, thread_name_prefix="stage")  # fills them

        self.batch_size = opt.batch_size
        self.seq_per_img = opt.seq_per_img
        self.use_flip = opt.use_flip
        self.use_crop = opt.use_crop
        self.aug_type = opt.aug_type
        self.top_words_count = opt.top_words_count

        self.ix_to_word = dataset.ix_to_word
        self.vocab_size = dataset.vocab_size
        self.seq_length = dataset.seq_length

        self.split_image_id = dataset.splits(
            train_only=bool(opt.train_only),
            online_training=bool(opt.online_training),
        )
        if opt.use_official_split:
            self.split_image_id = {
                s: [int(line.strip()) for line in open(getattr(opt, f"official_{s}_id_file"))]
                for s in ("train", "val", "test")
            }
        # `iterators` / `split_image_id` are the CONSUMED view (what has been
        # handed to the trainer — the state that belongs in a checkpoint);
        # `_prod_it` / `_order` are the production cursors advanced by batch
        # assembly (possibly ahead, on the prefetch thread).
        self.iterators = {"train": 0, "val": 0, "test": 0}
        self._prod_it = {"train": 0, "val": 0, "test": 0}
        self._order = {s: list(ids) for s, ids in self.split_image_id.items()}

        # PER-SPLIT RNG streams: the splits' prefetcher threads run
        # concurrently (train batches assemble while val evaluates), and a
        # shared stream would interleave draws timing-dependently — breaking
        # run-to-run reproducibility and, on multi-host runs, the lockstep
        # invariant that every host draws the same shuffle/caption/variant
        # sequence for the train stream
        self._rng = {
            s: random.Random(opt.seed + 7919 * i)
            for i, s in enumerate(("train", "val", "test"))
        }
        self._np_rng = {
            s: np.random.default_rng(opt.seed + 104729 * (i + 1))
            for i, s in enumerate(("train", "val", "test"))
        }
        # CONSUMED-view RNG snapshots (like `iterators`): the state of both
        # streams as of the last batch HANDED to the trainer. The live RNGs
        # run ahead of this on the prefetch thread, so a checkpoint must
        # record these snapshots — restoring construction-time seeds would
        # make every post-resume caption-slice/variant/shuffle draw diverge
        # from the uninterrupted run (real COCO: images with !=5 captions
        # and use_flip/use_crop draw every batch).
        self.rng_states = {s: self._snapshot_rng(s) for s in self._rng}

        self._prefetch_enabled = prefetch
        self._prefetchers: Dict[str, "_Prefetcher"] = {}

    # ----------------------------------------------------------------- vocab

    def get_vocab(self):
        return self.ix_to_word

    def get_vocab_size(self):
        return self.vocab_size

    def get_seq_length(self):
        return self.seq_length

    @property
    def top_words(self):
        return self.dataset.top_words

    # -------------------------------------------------------------- iterator

    def reset_iterator(self, split: str):
        # rewind the PRODUCTION state (live RNGs, order) to the consumed view
        # before zeroing cursors: the prefetcher over-runs consumption by up
        # to DEPTH+1 batches, advancing the live RNG streams past the
        # snapshot a checkpoint records — without the rewind, draws after a
        # reset depend on prefetch timing and diverge from a resumed run
        # (breaking the draw-exact resume contract of restore_state)
        self._stop_prefetcher(split)
        self._rewind_to_consumed(split)
        self.iterators[split] = 0
        self._prod_it[split] = 0

    def _rewind_to_consumed(self, split: str):
        """Roll production cursors/RNGs/order back to the consumed view
        (the state as of the last batch handed to the caller). Only safe
        with no live prefetcher for the split."""
        st = self.rng_states[split]
        self._rng[split].setstate(_as_py_rng_state(st["py"]))
        self._np_rng[split].bit_generator.state = st["np"]
        self._order[split] = list(self.split_image_id[split])
        self._prod_it[split] = self.iterators[split]

    def _snapshot_rng(self, split: str) -> dict:
        # Random.getstate() is an immutable tuple; Generator exposes a fresh
        # state dict per call — both pickle cleanly inside infos
        return {
            "py": self._rng[split].getstate(),
            "np": self._np_rng[split].bit_generator.state,
        }

    def restore_state(self, iterators: dict, split_image_id: dict,
                      rng_states: Optional[dict] = None):
        """Resume from checkpointed iterator state (train.py:49-50 contract).

        rng_states: the loader's `rng_states` snapshot riding in infos
        (per-split {"py", "np"} states). Without it (pre-existing
        checkpoints) the cursor/order still restore but the RNG streams
        keep their construction seeding — resume stays deterministic yet
        not draw-for-draw identical to the uninterrupted run."""
        for split in self.iterators:
            self._stop_prefetcher(split)
        self.iterators = dict(iterators)
        self._prod_it = dict(iterators)
        self.split_image_id = {s: list(v) for s, v in split_image_id.items()}
        self._order = {s: list(v) for s, v in split_image_id.items()}
        if rng_states:
            for split, st in rng_states.items():
                self._rng[split].setstate(_as_py_rng_state(st["py"]))
                self._np_rng[split].bit_generator.state = st["np"]
                self.rng_states[split] = self._snapshot_rng(split)

    def _next_image(self, split: str):
        """Advance the production cursor by one; returns (image_id, wrapped)."""
        ids = self._order[split]
        pos = self._prod_it[split]
        image_id = ids[pos]
        pos += 1
        wrapped = False
        if pos >= len(ids):
            pos = 0
            wrapped = True
            if split == "train":
                self._rng[split].shuffle(ids)
        self._prod_it[split] = pos
        return image_id, wrapped

    def _pick_variant(self, split: str) -> str:
        """Random augmentation variant (dataloader.py:432-443)."""
        if self.use_flip:
            hi = 10 if self.use_crop else 2
            return FLIP_TYPE_TO_VARIANT[int(self._np_rng[split].integers(0, hi))]
        return FLIP_TYPE_TO_VARIANT[self.aug_type]

    # ----------------------------------------------------------------- batch

    def get_batch(self, split: str, batch_size: Optional[int] = None,
                  seq_per_img: Optional[int] = None, variant: Optional[str] = None):
        if (
            self._prefetch_enabled
            and batch_size is None
            and seq_per_img is None
            and variant is None
        ):
            return self._get_prefetched(split)
        # direct (caller-thread) assembly must not race a live prefetcher
        # for the same split: stop it and rewind the production state it
        # advanced back to the consumed view, so no images are skipped and
        # the two threads never mutate _prod_it/_rng concurrently
        if split in self._prefetchers:
            self._stop_prefetcher(split)
            self._rewind_to_consumed(split)
        batch = self._assemble_batch(split, batch_size, seq_per_img, variant)
        self.iterators[split] = self._prod_it[split]
        self.split_image_id[split] = self._order[split][:]
        self.rng_states[split] = self._snapshot_rng(split)
        return batch

    def _assemble_batch(self, split, batch_size=None, seq_per_img=None, variant=None):
        B = batch_size or self.batch_size
        spi = seq_per_img or self.seq_per_img
        L = self.seq_length
        ds = self.dataset
        hi, hc = self.host_index, self.host_count
        # a real exception, not an assert: under `python -O` a stripped
        # check would silently drop the tail rows of every global batch
        if hc > 1 and B % hc != 0:
            raise ValueError(f"batch_size {B} must divide by the host count {hc}")
        B_local = B // hc
        lo = hi * B_local  # this rank's contiguous block of the global batch

        label_batch = np.zeros((B_local * spi, L + 2), dtype=np.int64)
        gts, infos = [], []
        local_rows = []  # (image_id, variant) of this rank's rows, in order
        wrapped = False

        rng = self._rng[split]
        for i in range(B):
            # the cursor and every draw advance for ALL global rows, so the
            # ranks stay in lockstep; only local rows materialise data
            image_id, w = self._next_image(split)
            wrapped = wrapped or w
            v = variant or self._pick_variant(split)
            caps = ds.captions_for_image(image_id)
            ncap = caps.shape[0]
            if ncap <= 0:  # not an assert: must survive python -O
                raise ValueError(
                    f"image {image_id} does not have any label"
                )
            if ncap < spi:
                seq = np.stack(
                    [caps[rng.randint(0, ncap - 1), :L] for _ in range(spi)]
                )
            else:
                start = rng.randint(0, ncap - spi)
                seq = caps[start : start + spi, :L]

            li = i - lo  # local row index
            if not 0 <= li < B_local:
                continue
            local_rows.append((image_id, v))
            label_batch[li * spi : (li + 1) * spi, 1 : L + 1] = seq
            gts.append(caps)
            ix = ds.image_id_to_index[image_id]
            infos.append(
                {
                    "ix": ix,
                    "id": image_id,
                    "file_path": ds.info["images"][ix].get("file_path", ""),
                }
            )

        # masks: ones through (#nonzero tokens + 2) (dataloader.py:309-314)
        mask_batch = np.zeros((B_local * spi, L + 2), dtype=np.float32)
        nonzeros = (label_batch != 0).sum(axis=1) + 2
        for r, n in enumerate(nonzeros):
            mask_batch[r, :n] = 1.0

        # top-word targets, -1 padded (dataloader.py:317-332), vectorized
        top = np.full((B_local * spi, self.top_words_count), -1, dtype=np.int64)
        top_map = ds.vocab_ix_to_top_ix
        for r in range(B_local * spi):
            ids = top_map[label_batch[r]]
            ids = np.unique(ids[ids >= 0])
            top[r, : len(ids)] = ids

        # feature rows, each repeated seq_per_img times
        # (dataloader.py:251-252), into a staging slot
        feats = self._stage(self._staging[split], local_rows, spi)
        fc_all, att_all = feats[0::2], feats[1::2]
        data = {}
        # several encoders always travel as arrays (the JAX loader does so
        # for feat_array only, and its synthetic fusion runs fail on that)
        if self.feature_type == "feat_array" or len(self.sources) > 1:
            data["fc_feats_array"] = fc_all
            data["att_feats_array"] = att_all
        else:
            data["fc_feats"] = fc_all[0]
            data["att_feats"] = att_all[0]

        data["labels"] = label_batch
        data["gts"] = gts
        data["masks"] = mask_batch
        data["bounds"] = {
            "it_pos_now": self._prod_it[split],
            "it_max": len(self._order[split]),
            "wrapped": wrapped,
        }
        data["infos"] = infos
        data["top_words"] = top
        return data

    def _stage(self, ring, local_rows, spi):
        """Each image's feature rows, repeated spi times, written straight
        into one pinned slot (packed stores hand out memory-mapped views,
        so every byte is copied once), the arrays filled by a thread pool
        (numpy copies release the GIL). A source with ``load_batch`` (the
        sharded store) reads the batch's rows in one batched gather."""
        rows = []
        for src in self.sources:
            if hasattr(src, "load_batch"):
                fc, att = src.load_batch([i for i, _ in local_rows],
                                         [v for _, v in local_rows])
                rows.append(list(zip(fc, att)))
            else:
                rows.append([src.load(i, v) for i, v in local_rows])
        rows = [[(fc, att.reshape(-1, att.shape[-1])) for fc, att in r] for r in rows]
        firsts = [x for r in rows for x in r[0]]

        def fill_rows(dst, parts, lo, hi):
            for r in range(lo, hi):
                dst[r * spi:(r + 1) * spi] = parts[r]

        def fill(arrays):
            step = max(1, -(-len(local_rows) // 4))
            jobs = [self._pool.submit(fill_rows, arrays[2 * e + k], [x[k] for x in r], lo,
                                      min(lo + step, len(r)))
                    for e, r in enumerate(rows) for k in (0, 1)
                    for lo in range(0, len(r), step)]
            for job in jobs:
                job.result()

        return ring.stage([(len(local_rows) * spi,) + x.shape for x in firsts], fill)

    # -------------------------------------------------------------- prefetch

    def _get_prefetched(self, split: str):
        if split not in self._prefetchers:
            self._prefetchers[split] = _Prefetcher(self, split)
        with span("loader.wait"):
            batch, state = self._prefetchers[split].get()
        # expose iterator state consistent with batches CONSUMED, so
        # checkpointed iterators resume exactly (train.py:49-50 contract)
        self.iterators[split] = state["iterators"]
        self.split_image_id[split] = state["split_image_id"]
        self.rng_states[split] = state["rng"]
        return batch

    def _stop_prefetcher(self, split: str):
        p = self._prefetchers.pop(split, None)
        if p is not None:
            p.stop()

    def close(self):
        for split in list(self._prefetchers):
            self._stop_prefetcher(split)
        for ring in self._staging.values():
            ring.close()
        self._pool.shutdown()


class _Prefetcher:
    """Double-buffered background batch assembly (the reference's
    BlobFetcher Pool(8) + 512-deep FIFO, dataloader.py:395-624)."""

    DEPTH = 2

    def __init__(self, loader: DataLoader, split: str):
        self.loader = loader
        self.split = split
        self.q: "queue.Queue" = queue.Queue(maxsize=self.DEPTH)
        self._stop = threading.Event()
        self._error = None  # sticky: every get() after a failure re-raises
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                with span("loader.fill"):
                    batch = self.loader._assemble_batch(self.split)
            except Exception as e:  # surface IO/shape errors to the consumer
                self._error = e  # set BEFORE the sentinel so get() never
                self._put(("error", e))  # blocks on the dead thread's queue
                return
            state = {
                "iterators": self.loader._prod_it[self.split],
                "split_image_id": self.loader._order[self.split][:],
                # RNG states as of THIS batch (the live streams keep
                # advancing on this thread — the consumed view must ride
                # with the batch, like the cursor)
                "rng": self.loader._snapshot_rng(self.split),
            }
            self._put(("ok", (batch, state)))
            # drop this thread's reference before assembling the next batch:
            # a pinned slot is reused only once no view of it is left
            del batch, state

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def get(self):
        # once the worker has died on an error, deliver any batches it
        # queued first, then raise on EVERY subsequent call — a consumer
        # that catches and retries must not block on the dead queue
        try:
            kind, payload = self.q.get(block=self._error is None)
        except queue.Empty:
            kind, payload = "error", self._error
        if kind == "error":
            raise RuntimeError(
                f"batch prefetcher for split '{self.split}' failed"
            ) from payload
        return payload

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        # join WITHOUT a timeout: a thread still inside _assemble_batch would
        # otherwise write the production cursors after reset_iterator zeroed
        # them (assembly is bounded by one batch of IO, so this terminates)
        self.thread.join()
