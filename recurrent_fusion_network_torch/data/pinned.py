"""Page-locked staging of batch features and their copy on a side stream.

A copy from pageable host memory to the card blocks the host until it has
run, and runs behind whatever the compute stream has queued: the train
loops' host then waits for the step before it can queue the next one. The
port stages instead:

  * ``PinnedRing``: the loader writes each batch's feature arrays into
    host buffers (torch tensors, page-locked with ``pin_memory=True`` for a
    CUDA device) and hands them on as numpy views, so the batch dict keeps
    its numpy contract. A slot is filled again only once the copy of its
    last batch has completed on the card, or once no view of it is alive
    (a batch that was dropped uncopied, or any batch on the CPU). A ring
    holds up to ``SLOTS`` page-locked slots; in ordinary memory it adds a
    slot whenever none is free, so a consumer that keeps its batches never
    waits.
  * ``SideStreamCopier``: ``copy`` (``device_batch`` on a CUDA device)
    queues the batch's host-to-device copies with ``non_blocking=True`` on
    a side ``torch.cuda.Stream``, records an event there, makes the compute
    stream wait on it and hands the event to the staging slot. Arrays that
    are not staged views are pinned first (``Tensor.pin_memory``, one host
    copy). Neither step waits for the card, so the host queues batch k+1's
    copy and step while the card still runs step k.

A failure to pin raises: there is no pageable fallback on a CUDA device. On
the CPU ``device_batch`` hands the arrays over as tensors sharing their
memory. The staged-buffer table and the per-device copiers are process-wide:
``device_batch`` takes only the batch dict, so it finds a staged array's slot
by its address.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

SLOTS = 6  # page-locked batches per split at a time

# data pointer of a staged buffer -> (slot, its pinned tensor)
_STAGED: Dict[int, Tuple["_Slot", torch.Tensor]] = {}
_STAGED_LOCK = threading.Lock()


class _Slot:
    def __init__(self):
        self.tensors: List[torch.Tensor] = []
        self.shapes: Tuple = ()
        self.live_views = 0  # numpy views handed out and not yet collected
        self.event: Optional[torch.cuda.Event] = None  # the last copy's

    def reusable(self) -> bool:
        """Copied (its views belong to the ring again once the copy has
        run), or dropped uncopied with no view left."""
        if self.event is not None:
            return self.event.query()
        return self.live_views == 0


class PinnedRing:
    """Sets of host buffers for one split's batches: up to ``SLOTS`` of
    page-locked memory (``pin``), else as many as are in use."""

    def __init__(self, *, pin: bool):
        self.pin = pin
        self._slots: List[_Slot] = []
        self._cond = threading.Condition()

    def stage(self, shapes: Sequence[Tuple[int, ...]], fill) -> List[np.ndarray]:
        """One slot of float32 buffers of ``shapes``: ``fill(arrays)`` writes
        them (through views the ring does not track, so helper threads that
        keep a reference do not hold the slot), then the batch's numpy views
        of them are returned."""
        slot = self._acquire(tuple(tuple(s) for s in shapes))
        try:
            fill([t.numpy() for t in slot.tensors])
        finally:
            self._view_died(slot)  # the hold _acquire took
        return [self._track(slot, t.numpy()) for t in slot.tensors]

    def _track(self, slot: _Slot, view: np.ndarray) -> np.ndarray:
        with self._cond:
            slot.live_views += 1
        weakref.finalize(view, self._view_died, slot)
        return view

    def _view_died(self, slot: _Slot) -> None:
        with self._cond:
            slot.live_views -= 1
            self._cond.notify_all()

    def _acquire(self, shapes) -> _Slot:
        with self._cond:
            while True:
                slot = self._free_slot()
                if slot is None and (not self.pin or len(self._slots) < SLOTS):
                    slot = _Slot()
                    self._slots.append(slot)
                if slot is not None:
                    slot.event = None
                    slot.live_views += 1  # held while it is filled
                    break
                self._cond.wait(timeout=0.002)  # copies finish on their own
        if slot.shapes != shapes:
            self._allocate(slot, shapes)
        return slot

    def _free_slot(self) -> Optional[_Slot]:
        return next((slot for slot in self._slots if slot.reusable()), None)

    def _allocate(self, slot: _Slot, shapes) -> None:
        with _STAGED_LOCK:
            for t in slot.tensors:
                _STAGED.pop(t.data_ptr(), None)
        slot.tensors = [torch.empty(s, dtype=torch.float32, pin_memory=self.pin)
                        for s in shapes]
        slot.shapes = shapes
        if self.pin:  # only page-locked buffers are copied as staged
            with _STAGED_LOCK:
                for t in slot.tensors:
                    _STAGED[t.data_ptr()] = (slot, t)

    def close(self) -> None:
        with self._cond:
            slots, self._slots = self._slots, []
        with _STAGED_LOCK:
            for slot in slots:
                for t in slot.tensors:
                    _STAGED.pop(t.data_ptr(), None)


def staged(array: np.ndarray):
    """(slot, pinned tensor) when ``array`` is a whole page-locked staged
    buffer, else None."""
    if not isinstance(array, np.ndarray):
        return None
    with _STAGED_LOCK:
        hit = _STAGED.get(array.ctypes.data)
    if hit is None or tuple(hit[1].shape) != array.shape:
        return None
    return hit


class SideStreamCopier:
    """Host-to-device batch copies on a side stream of ``device``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.timing = False  # record every copy's events and host time
        self.timings: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.host_ms: List[float] = []

    def copy(self, arrays: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """numpy arrays -> device tensors, ready for the current stream's
        later work; the host does not wait for the copies."""
        t0 = time.perf_counter()
        compute = torch.cuda.current_stream(self.device)
        slots, sources = [], []
        for a in arrays:
            hit = staged(a)
            if hit is not None:
                slots.append(hit[0])
                sources.append(hit[1])
            else:
                sources.append(torch.from_numpy(np.ascontiguousarray(a)).pin_memory())
        with torch.cuda.stream(self.stream):
            start = torch.cuda.Event(enable_timing=True) if self.timing else None
            if start is not None:
                start.record(self.stream)
            out = [s.to(self.device, non_blocking=True) for s in sources]
            done = torch.cuda.Event(enable_timing=self.timing)
            done.record(self.stream)
        if start is not None:
            self.timings.append((start, done))
        compute.wait_event(done)
        for t in out:  # allocated on the side stream, used on the compute one
            t.record_stream(compute)
        for slot in slots:
            slot.event = done
        if self.timing:
            self.host_ms.append((time.perf_counter() - t0) * 1e3)
        return out


_COPIERS: Dict[torch.device, SideStreamCopier] = {}


def copier(device) -> SideStreamCopier:
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _COPIERS:
        _COPIERS[device] = SideStreamCopier(device)
    return _COPIERS[device]


def batch_feats(data):
    """The loader batch's features on the host: (fc list, att list), one
    numpy array per encoder (the JAX ``batch_feats(..., as_numpy=True)``;
    the port hands every model lists)."""
    if "fc_feats_array" in data:
        return list(data["fc_feats_array"]), list(data["att_feats_array"])
    return [data["fc_feats"]], [data["att_feats"]]


def device_batch(data, device, compute_dtype=None):
    """The loader's numpy batch dict -> (fc list, att list, labels, masks,
    top_words) on ``device``, features in the compute dtype. On a CUDA
    device every array is copied on the side stream from page-locked
    memory; on the CPU the tensors share the arrays' memory."""
    device = torch.device(device)
    fcs, atts = batch_feats(data)
    host = fcs + atts + [data["labels"], data["masks"], data["top_words"]]
    if device.type == "cuda":
        out = copier(device).copy(host)
    else:
        out = [torch.as_tensor(x, device=device) for x in host]
    n = len(fcs)
    feats = out[:2 * n]
    if compute_dtype is not None:
        feats = [t.to(compute_dtype) for t in feats]
    return feats[:n], feats[n:], out[2 * n], out[2 * n + 1], out[2 * n + 2]
