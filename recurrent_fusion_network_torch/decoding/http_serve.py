"""HTTP caption service: concurrent requests batched onto the GPU.

Counterpart of ``recurrent_fusion_network_tpu/decoding/http_serve.py``: a
threading HTTP server whose handler threads each submit one image's
features to a ``CaptionServer`` and block on the Future, so concurrent
requests coalesce into static-shape device batches. stdlib only.

Endpoints:
  GET  /healthz  -> {"ok": true, "model": ..., "batch_size": ..., ...}
  POST /caption  -> body {"fc": [[...] per encoder], "att": [[[...]] per
                    encoder]} or binary npz (Content-Type application/x-npz
                    or zip magic) with arrays fc_0..fc_{M-1}, att_0..att_{M-1}
                    resp {"caption": str, "logprob": float}
  POST /caption_image -> body: one image file's bytes (JPEG, PNG, ...);
                    resp as /caption. Only when the service has a backbone
                    (serve --backbone_weights) and a single-encoder model.
A single-encoder model (ShowTell, ReviewNet) takes one of each; ShowTell
reads no attention features, so its att array may have any width.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence

import numpy as np
import torch

from ..data.vocab import decode_sequence
from ..device import resolve_device
from ..ops.initializers import tree_leaves, tree_map
from .api import model_sample
from .serve import CaptionServer

# request-body cap: flagship 5-encoder f32 features are ~13 MB as npz
MAX_BODY = 256 * 1024 * 1024


def parse_features_payload(body: bytes, content_type: str = "",
                           max_bytes: int = 512 << 20):
    """Request body -> (fcs, atts): one image's per-encoder feature arrays.

    JSON text {"fc": [...], "att": [...]} or a binary npz of fc_0../att_0..
    arrays. Raises ValueError / KeyError / JSON errors on malformed payloads
    (client errors). The npz's uncompressed size is bounded by max_bytes
    before any member is read, so a small deflated body cannot expand into
    an allocation that exhausts the host.
    """
    if content_type.split(";")[0].strip() == "application/x-npz" \
            or body[:4] == b"PK\x03\x04":
        import zipfile
        import zlib

        try:
            z = np.load(io.BytesIO(body), allow_pickle=False)
            if not hasattr(z, "files"):
                raise ValueError(
                    "expected an npz payload (np.savez of fc_0../att_0..), got a "
                    "bare array")
            total = sum(i.file_size for i in z.zip.infolist())
            if total > max_bytes:
                raise ValueError(
                    f"npz payload decompresses to {total} bytes (limit {max_bytes})")
            n = sum(1 for k in z.files if k.startswith("fc_"))
            if n == 0:
                raise ValueError("npz payload has no fc_0..fc_{M-1} arrays")
            try:
                fcs = [np.asarray(z[f"fc_{i}"], np.float32) for i in range(n)]
                atts = [np.asarray(z[f"att_{i}"], np.float32) for i in range(n)]
            except KeyError as e:
                raise ValueError(f"npz payload missing array {e}") from e
        except (zipfile.BadZipFile, OSError, zlib.error) as e:
            raise ValueError(f"bad npz payload: {e}") from e
        return fcs, atts
    req = json.loads(body)
    return ([np.asarray(f, np.float32) for f in req["fc"]],
            [np.asarray(a, np.float32) for a in req["att"]])


def feature_shapes(model):
    """-> (fc widths, att (A, D) shapes), one per encoder the model reads:
    RFNet's M encoders or a single-encoder model's one. ShowTell reads no
    attention features; (1, 1) stands in for them."""
    if hasattr(model, "fc_feat_sizes"):
        return list(model.fc_feat_sizes), list(zip(model.att_nums, model.att_feat_sizes))
    if hasattr(model, "att_feat_size"):
        return [model.fc_feat_size], [(model.att_num, model.att_feat_size)]
    return [model.fc_feat_size], [(1, 1)]


def decode_image_bytes(image_bytes: bytes, image_size: int) -> np.ndarray:
    """An uploaded image -> (1, size, size, 3) f32 in [0, 1]. PIL's default
    resample, as the JAX package's service resizes (the extract CLI's
    ``load_image`` asks for BILINEAR)."""
    from PIL import Image

    img = Image.open(io.BytesIO(image_bytes)).convert("RGB")
    img = img.resize((image_size, image_size))
    return np.asarray(img, np.float32)[None] / 255.0


class CaptionService:
    """The batched decode server plus vocab decoding, and an optional
    raw-image backbone.

    params: the model's tensor tree (moved to ``device`` once here); its
    floating dtype is the compute dtype, and requests are cast to it at
    submit. backbone: None or (backbone params on ``device``, features_fn,
    image_size) from ``data/feature_extraction/backbones.build_backbone``.
    """

    def __init__(self, model, params, vocab, *, device=None, batch_size: int = 16,
                 beam_size: int = 3, depth: int = 2, flush_interval: float = 0.005,
                 backbone=None):
        self.device = resolve_device(device)
        self.vocab = vocab
        self.model = model
        self.beam_size = beam_size
        self.batch_size = batch_size
        if backbone is not None and hasattr(model, "fc_feat_sizes"):
            # /caption_image extracts ONE backbone's features: against a
            # multi-encoder model every such request would fail at decode
            raise ValueError(
                f"--backbone_weights serves single-encoder models only; "
                f"{type(model).__name__} expects "
                f"{len(model.fc_feat_sizes)} encoders (drop the backbone or "
                f"serve a show_tell/review_net checkpoint)"
            )
        self.backbone = backbone
        params = tree_map(lambda x: x.to(self.device), params)

        def decode(fcs, atts):
            with torch.inference_mode():
                out = model_sample(model, params, fcs, atts, beam_size=beam_size)
            return {"seq": out.seq, "seq_logprobs": out.seq_logprobs}

        self._decode = decode
        cast_dtype = next((x.dtype for x in tree_leaves(params)
                           if x.is_floating_point()), None)
        self.single = not hasattr(model, "fc_feat_sizes")
        if self.single:
            # ShowTell reads no attention features: their width is free
            feat_dims = ((model.fc_feat_size,), (getattr(model, "att_feat_size", None),))
        else:
            feat_dims = (tuple(model.fc_feat_sizes), tuple(model.att_feat_sizes))
        self.server = CaptionServer(
            decode, batch_size, device=self.device, depth=depth,
            flush_interval=flush_interval, feat_dims=feat_dims, cast_dtype=cast_dtype)

    # ------------------------------------------------------------------ API

    def caption_features(self, fcs: Sequence, atts: Sequence) -> dict:
        """One image's per-encoder features -> {'caption', 'logprob'}."""
        fut = self.server.submit([np.asarray(f, np.float32) for f in fcs],
                                 [np.asarray(a, np.float32) for a in atts])
        return self.postprocess_row(fut.result())

    def postprocess_row(self, row) -> dict:
        """One decode-output row -> {'caption', 'logprob'}."""
        toks = np.asarray(row["seq"])
        caption = decode_sequence(self.vocab, toks[None, :])[0]
        lps = np.asarray(row["seq_logprobs"])
        # sentence log-prob: generated tokens through the first EOS
        eos = np.nonzero(toks == 0)[0]
        n = int(eos[0]) + 1 if len(eos) else len(toks)
        return {"caption": caption, "logprob": float(lps[:n].sum())}

    def caption_image(self, image_bytes: bytes) -> dict:
        """Raw image -> backbone features -> queued caption."""
        if self.backbone is None:
            raise RuntimeError("service started without a backbone "
                               "(--backbone_weights); /caption_image disabled")
        bb_params, features_fn, image_size = self.backbone
        img = torch.from_numpy(decode_image_bytes(image_bytes, image_size)).to(self.device)
        fc, att = features_fn(bb_params, img)
        att = att.reshape(att.shape[0], -1, att.shape[-1])
        return self.caption_features([fc[0].cpu().numpy()], [att[0].cpu().numpy()])

    def warmup(self) -> None:
        """Run one full-size zero batch before serving traffic: builds the
        kernel library and warms the allocator, so the first live request
        does not pay for them."""
        fc_dims, att_shapes = feature_shapes(self.model)
        B, dt = self.batch_size, self.server.cast_dtype
        fcs = [torch.zeros((B, d), dtype=dt, device=self.device) for d in fc_dims]
        atts = [torch.zeros((B, n, d), dtype=dt, device=self.device) for n, d in att_shapes]
        tree_map(lambda x: x.cpu(), self._decode(fcs, atts))  # readback: done

    def close(self):
        self.server.close()


def make_handler(service: CaptionService):
    class Handler(BaseHTTPRequestHandler):
        # per-connection socket timeout: a client that stalls mid-upload
        # cannot pin this handler thread forever
        timeout = 120

        def log_message(self, *a):  # quiet by default
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "ok": True,
                    "model": type(service.model).__name__,
                    "batch_size": service.batch_size,
                    "beam_size": service.beam_size,
                    "stats": dict(service.server.stats),
                })
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            # a negative Content-Length would make rfile.read(-1) block until
            # EOF; a non-numeric one would raise with no response
            try:
                n = int(self.headers.get("Content-Length", 0) or 0)
            except ValueError:
                n = -1
            if n < 0:
                self._send(400, {"error": "invalid Content-Length"})
                return
            if n > MAX_BODY:
                self._send(413, {"error": "body too large"})
                return
            body = self.rfile.read(n)
            if self.path not in ("/caption", "/caption_image"):
                self._send(404, {"error": "unknown path"})
                return
            try:
                if self.path == "/caption":
                    fcs, atts = parse_features_payload(
                        body, self.headers.get("Content-Type", ""))
                    out = service.caption_features(fcs, atts)
                else:
                    out = service.caption_image(body)
            except (json.JSONDecodeError, KeyError, TypeError, ValueError,
                    OSError) as e:  # malformed request or image: a client error
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            except RuntimeError as e:
                # server closed/closing (shutdown drain) is retryable: 503
                code = 503 if "closed" in str(e) else 500
                self._send(code, {"error": f"{type(e).__name__}: {e}"})
                return
            except Exception as e:  # device/batch failure -> server error
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                self._send(200, out)
            except OSError:  # client disconnected mid-write
                pass

    return Handler


class _Server(ThreadingHTTPServer):
    # stdlib default backlog is 5: concurrent clients would be reset
    request_queue_size = 128
    daemon_threads = True


def run_server(service: CaptionService, host: str = "0.0.0.0",
               port: int = 8080) -> ThreadingHTTPServer:
    """Start the HTTP front end on a thread; returns the running server
    (port 0 picks a free port: read ``server_address``)."""
    httpd = _Server((host, port), make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    httpd._serve_thread = thread  # for clean shutdown by callers and tests
    return httpd
