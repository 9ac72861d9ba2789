"""Pipelined batch decoding for serving.

Counterpart of ``recurrent_fusion_network_tpu/decoding/serve.py``. PyTorch
queues CUDA work asynchronously: a decode that never reads a tensor value
on the host returns as soon as its kernels are queued, and only the
readback blocks. Keeping a small window of batches in flight therefore
overlaps the host's dispatch of the next batch with the device's compute
of the current one. A ``CaptionServer`` on a device mesh
(``parallel/mesh.py::DeviceMesh``) splits each batch's rows into one block
a device and queues every block's decode before any readback.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Iterable, Iterator, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.initializers import tree_map
from ..parallel.mesh import join_blocks, with_dp_sharding
from ..utils.profiling import count, span


def _safe_result(fut: Future, value) -> None:
    """Resolve a request Future that its client may have cancelled; an
    unguarded set_result would raise InvalidStateError and kill the worker."""
    if not fut.cancelled():
        try:
            fut.set_result(value)
        except InvalidStateError:  # cancelled between the check and the set
            pass


def _safe_exception(fut: Future, exc: BaseException) -> None:
    if not fut.cancelled():
        try:
            fut.set_exception(exc)
        except InvalidStateError:
            pass


def pipelined_map(fn: Callable, items: Iterable, *, depth: int = 2) -> Iterator:
    """Apply an asynchronously dispatching ``fn`` over ``items``, keeping up
    to ``depth`` results in flight; yields (item, result) in order.

    fn must return device tensors without reading them on the host; the
    caller does the blocking readback on the yielded result, by which time
    the next ``depth`` dispatches are already queued on the device.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    window: deque = deque()
    for item in items:
        window.append((item, fn(item)))
        if len(window) > depth:
            yield window.popleft()
    while window:
        yield window.popleft()


def pipelined_decode(decode_fn: Callable, batches: Iterable[Tuple], *,
                     depth: int = 2) -> Iterator:
    """Decode a stream of feature batches with ``depth`` batches in flight.

    decode_fn: (fc, att) -> decode output (device tensors, e.g. a
    ``model_sample`` closure). Yields ((fc, att), output) pairs in order.
    """
    return pipelined_map(lambda b: decode_fn(*b), batches, depth=depth)


class CaptionServer:
    """A request queue in front of fixed-shape, pipelined batch decoding.

    Callers ``submit()`` one image's feature set at a time and get a Future;
    a worker thread assembles requests into static-shape batches, uploads
    only the real rows of a partial batch (rounded up to a power-of-2
    bucket) and zero-fills the rest on the device, keeps up to ``depth``
    batches in flight, reads results back, and resolves each request's
    Future with its row of the output tree (numpy leaves).

    decode_fn: (fcs, atts) -> tree of device tensors whose leaves lead with
    the batch axis; fcs / atts are lists of per-encoder (B, D) and (B, A, D)
    tensors on ``device``.

    With a ``mesh`` (JAX serve.py:84-168) each batch is padded on the host
    to ``batch_size`` rows (no device padding), split into the mesh's dp
    blocks, block k decoded on ``mesh.devices[k]`` by ``decode_fn[k]``
    (``decode_fn`` is then a list of callables, one a device), every block
    queued before any readback, and the blocks' rows concatenated in order.
    ``batch_size`` must divide by the mesh's dp.
    """

    def __init__(self, decode_fn, batch_size: int, *, device=None,
                 depth: int = 2, flush_interval: float = 0.005, feat_dims=None,
                 cast_dtype=None, mesh=None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if mesh is not None and batch_size % mesh.dp:
            raise ValueError(f"batch_size {batch_size} must divide by the mesh dp "
                             f"extent {mesh.dp}")
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        if mesh is not None and (callable(decode_fn) or len(decode_fn) != mesh.dp):
            raise ValueError(f"on a mesh of {mesh.dp} devices decode_fn is a list of "
                             f"{mesh.dp} callables, one a device")
        self.decode_fn = decode_fn
        # the real rows of a partial batch are uploaded and zero-filled on
        # the device, except on a mesh, whose blocks are cut from full rows
        self.device_pad = mesh is None
        self.batch_size = batch_size
        self.depth = depth
        self.flush_interval = flush_interval
        # optional ((fc_dim, ...), (att_dim, ...)) per-encoder dims: checked
        # at submit(), so a malformed first request cannot establish a bogus
        # shape contract that then rejects all well-formed traffic
        self.feat_dims = feat_dims
        # requests are cast to the model's compute dtype at submit(): bf16
        # halves the queued and uploaded bytes
        self.cast_dtype = cast_dtype
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0, "h2d_rows": 0}
        self._queue: queue.Queue = queue.Queue()
        self._closing = threading.Event()
        self._spec = None  # per-request shape contract, set by first submit
        self._spec_confirmed = False  # a batch under it dispatched OK
        self._spec_lock = threading.Lock()  # submit() runs on many threads
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------ API

    def submit(self, fcs: Sequence, atts: Sequence) -> Future:
        """Enqueue one image's per-encoder features ((D,) fc and (A, D) att
        per encoder); returns a Future resolving to that image's row of the
        decode output tree. Its host time up to the queue put rides with the
        request, and the worker records it under ``serve.submit`` as it takes
        the batch: the client threads, which pace a bulk load, make no record."""
        t0 = time.perf_counter()
        if self._closing.is_set():
            raise RuntimeError("server is closed")
        fcs = [torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in fcs]
        atts = [torch.from_numpy(np.ascontiguousarray(x, np.float32)) for x in atts]
        if self.cast_dtype is not None and self.cast_dtype != torch.float32:
            fcs = [x.to(self.cast_dtype) for x in fcs]
            atts = [x.to(self.cast_dtype) for x in atts]
        # reject shape mismatches here: a malformed request must fail alone
        spec = (tuple(tuple(x.shape) for x in fcs), tuple(tuple(x.shape) for x in atts))
        if self.feat_dims is not None:
            self._validate_dims(fcs, atts)
        with self._spec_lock:
            if self._spec is None:
                self._spec = spec
            elif spec != self._spec:
                raise ValueError(
                    f"request feature shapes {spec} differ from the server's "
                    f"established contract {self._spec}")
        fut: Future = Future()
        self._queue.put((fcs, atts, fut, time.perf_counter() - t0))
        # close() racing this submit: if the worker already exited, fail the
        # leftovers here; while it lives it still serves queued requests
        if self._closing.is_set() and not self._worker.is_alive():
            self._drain_failed()
        return fut

    def _validate_dims(self, fcs, atts) -> None:
        """Check one request's trailing dims and ranks against feat_dims."""
        fc_dims, att_dims = self.feat_dims
        got = (tuple(x.shape[-1] if x.dim() else 0 for x in fcs),
               tuple(x.shape[-1] if x.dim() else 0 for x in atts))

        def bad(gots, dims, rank, arrs):
            return (len(arrs) != len(dims)
                    or any(d is not None and g != d for g, d in zip(gots, dims))
                    or any(x.dim() != rank for x in arrs))

        if bad(got[0], fc_dims, 1, fcs) or bad(got[1], att_dims, 2, atts):
            raise ValueError(
                f"request feature dims {got} do not match the model's "
                f"per-encoder dims (fc={tuple(fc_dims)}, att={tuple(att_dims)}; "
                "fc rank 1, att rank 2)")

    def close(self) -> None:
        """Flush pending requests, drain in-flight batches, stop the worker."""
        self._closing.set()
        self._worker.join()
        # a submit() racing close() can land after the worker's final drain
        self._drain_failed()

    def _drain_failed(self) -> None:
        while True:
            try:
                _, _, fut, _ = self._queue.get_nowait()
            except queue.Empty:
                break
            _safe_exception(fut, RuntimeError("server closed before dispatch"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------------- worker

    def _run(self) -> None:
        inflight: deque = deque()
        while True:
            # drain to depth-1 before dispatching the next batch, so at most
            # `depth` batches are ever in flight
            while len(inflight) >= self.depth:
                self._resolve(*inflight.popleft())
            # park only when nothing is in flight; a quiet queue must not
            # delay delivering already-dispatched work
            with span("serve.gather") as gather:
                group = self._gather(park=not inflight)
                if not group:  # only the calls that return a batch count
                    gather.drop()
            if group:
                for g in group:
                    count("serve.submit", g[3])
                inflight.append(self._dispatch(group))
                self.stats["batches"] += 1
                self.stats["requests"] += len(group)
                continue
            if inflight:
                self._resolve(*inflight.popleft())
                continue
            if self._closing.is_set() and self._queue.empty():
                return

    def _gather(self, park: bool):
        """Collect up to batch_size requests. A partial batch flushes
        flush_interval after its first request. park=True waits for a first
        request while the server stays open; park=False gives the queue one
        flush_interval."""
        group = []
        deadline = None
        while len(group) < self.batch_size:
            if deadline is None:
                timeout = 0.05 if park else self.flush_interval
            else:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
            if self._closing.is_set():
                try:
                    group.append(self._queue.get_nowait())
                    continue
                except queue.Empty:
                    break
            try:
                group.append(self._queue.get(timeout=timeout))
            except queue.Empty:
                if deadline is not None or not park:
                    break
                continue
            if deadline is None:
                deadline = time.monotonic() + self.flush_interval
        return group

    def _dispatch(self, group):
        # one batch = one shape: after a spec reset, requests of the old spec
        # may sit next to new ones; keep the head request's shapes and fail
        # strays individually
        head = (tuple(tuple(x.shape) for x in group[0][0]),
                tuple(tuple(x.shape) for x in group[0][1]))
        kept = []
        for g in group:
            spec = (tuple(tuple(x.shape) for x in g[0]), tuple(tuple(x.shape) for x in g[1]))
            if spec == head:
                kept.append(g)
            else:
                _safe_exception(g[2], ValueError(
                    f"request feature shapes {spec} differ from this batch's "
                    f"{head} (stale contract after a failed first batch)"))
        group = kept
        futures = [g[2] for g in group]
        try:
            n = len(group)
            self.stats["padded_rows"] += self.batch_size - n
            # smallest power-of-2 bucket holding the real rows: the host
            # stacks and uploads `bucket` rows, the device zero-fills the
            # rest (their outputs are discarded by _resolve)
            with span("serve.assemble"):
                bucket = (min(self.batch_size, 1 << (n - 1).bit_length()) if self.device_pad
                          else self.batch_size)
                rows_fc = [g[0] for g in group] + [group[-1][0]] * (bucket - n)
                rows_att = [g[1] for g in group] + [group[-1][1]] * (bucket - n)
                n_enc = len(rows_fc[0])
                self.stats["h2d_rows"] += bucket
                if self.mesh is not None:
                    fcs = [torch.stack([r[e] for r in rows_fc]) for e in range(n_enc)]
                    atts = [torch.stack([r[e] for r in rows_att]) for e in range(n_enc)]
                else:
                    fcs = [self._upload([r[e] for r in rows_fc]) for e in range(n_enc)]
                    atts = [self._upload([r[e] for r in rows_att]) for e in range(n_enc)]
                    if bucket < self.batch_size:
                        fcs, atts = self._pad_on_device(fcs), self._pad_on_device(atts)
            if self.mesh is not None:
                out = [fn(*block) for fn, block in
                       zip(self.decode_fn, with_dp_sharding(self.mesh, (fcs, atts)))]
            else:
                out = self.decode_fn(fcs, atts)
        except Exception as e:  # malformed request / dispatch error:
            for f in futures:  # fail this batch only, keep the worker alive
                _safe_exception(f, e)
            with self._spec_lock:
                if not self._spec_confirmed:
                    # the contract came from a batch that never dispatched
                    # (likely a malformed first request): reset it so later
                    # well-formed requests are not rejected forever
                    self._spec = None
            return [], None
        with self._spec_lock:
            self._spec_confirmed = True
        return futures, out

    def _upload(self, rows):
        """Stack rows on the host and copy them to the device. To a GPU the
        copy goes from pinned memory without blocking: a blocking copy would
        wait for the batches already queued and undo the depth window."""
        x = torch.stack(rows)
        if self.device.type != "cuda":
            return x.to(self.device)
        return x.pin_memory().to(self.device, non_blocking=True)

    def _pad_on_device(self, xs):
        """Zero-fill bucket-row tensors out to batch_size on the device."""
        return [torch.cat([x, x.new_zeros((self.batch_size - x.shape[0],) + x.shape[1:])])
                for x in xs]

    def _resolve(self, futures, out) -> None:
        if not futures:
            return
        try:
            if self.mesh is not None:  # the blocks' rows, in order
                out = join_blocks(out)
            host = tree_map(lambda x: x.cpu().numpy(), out)  # the one sync
        except Exception as e:  # device-side execution error
            for f in futures:
                _safe_exception(f, e)
            return
        for i, fut in enumerate(futures):
            _safe_result(fut, tree_map(lambda x: x[i], host))
