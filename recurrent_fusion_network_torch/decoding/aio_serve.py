"""asyncio HTTP front end for CaptionService.

Counterpart of ``recurrent_fusion_network_tpu/decoding/aio_serve.py``, the
serve CLI's default front end. The threading front end (``http_serve.py``)
spends a Python thread per request on header parsing and a blocking Future
wait; this one serves the same endpoints from one event loop: asyncio stream
parsing, HTTP/1.1 keep-alive connections, and ``asyncio.wrap_future`` over
the ``CaptionServer``'s Futures, so an in-flight request costs a coroutine
instead of a thread. Requests still coalesce into the server's static-shape
device batches; only the HTTP ingest changes. stdlib and numpy.

Endpoints (as ``http_serve.py``):
  GET  /healthz  -> service status JSON, with "frontend": "asyncio"
  POST /caption  -> {"fc": [...], "att": [...]} JSON or a binary npz
                    (Content-Type application/x-npz; fc_0../att_0.. arrays,
                    ``http_serve.parse_features_payload``) -> caption JSON
Status codes: 400 for a malformed request, 413 for an oversize head or body,
503 once the server is closed, 500 for a failed batch.

``/caption_image`` stays on the threading front end: decoding an image is
CPU-bound work that would block the loop (the serve CLI switches to it when
``--backbone_weights`` is set).
"""

from __future__ import annotations

import asyncio
import json
import threading
from typing import Optional

from .http_serve import MAX_BODY, parse_features_payload

_MAX_HEADER = 64 * 1024
_REASON = {200: "OK", 400: "Bad Request", 404: "Not Found", 413: "Payload Too Large",
           500: "Internal Server Error", 503: "Service Unavailable"}


def _response(code: int, body: bytes, keep_alive: bool) -> bytes:
    return (f"HTTP/1.1 {code} {_REASON.get(code, 'OK')}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n"
            "\r\n").encode() + body


class AsyncCaptionFrontend:
    """One event loop, in a daemon thread, serving a CaptionService over
    HTTP/1.1 keep-alive."""

    def __init__(self, service):
        self.service = service
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self.port: Optional[int] = None
        # requests past their head and not yet answered, read by the drain;
        # written only on the loop's thread
        self._inflight = 0
        # set by the drain: handlers admit no new request (closing the
        # listener alone stops new connections, not keep-alive ones)
        self._draining = False

    # ------------------------------------------------------------- request

    async def _caption(self, payload: bytes, content_type: str = "") -> tuple:
        try:
            fcs, atts = parse_features_payload(payload, content_type)
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            return 400, {"error": f"{type(e).__name__}: {e}"}
        try:
            fut = self.service.server.submit(fcs, atts)
        except ValueError as e:  # shapes off the contract: the caller's fault
            return 400, {"error": f"{type(e).__name__}: {e}"}
        except RuntimeError as e:  # server closed: retryable
            return 503, {"error": f"{type(e).__name__}: {e}"}
        try:
            row = await asyncio.wrap_future(fut)
        except Exception as e:  # the batch failed on the device
            return 500, {"error": f"{type(e).__name__}: {e}"}
        return 200, self.service.postprocess_row(row)

    async def _reply(self, writer, code: int, body: bytes, keep: bool) -> None:
        writer.write(_response(code, body, keep))
        await writer.drain()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while not self._draining:  # a drain cuts idle keep-alive connections
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except asyncio.IncompleteReadError:
                    return  # the client closed between requests
                except asyncio.LimitOverrunError:  # a head past _MAX_HEADER
                    await self._reply(writer, 413, b'{"error":"headers"}', False)
                    return
                lines = head.decode("latin-1").split("\r\n")
                try:
                    method, path, _ = lines[0].split(" ", 2)
                except ValueError:
                    await self._reply(writer, 400, b'{"error":"request line"}', False)
                    return
                headers = {}
                for ln in lines[1:]:
                    if ":" in ln:
                        k, v = ln.split(":", 1)
                        headers[k.strip().lower()] = v.strip()
                try:
                    length = int(headers.get("content-length", 0) or 0)
                except ValueError:
                    length = -1
                if length < 0:
                    await self._reply(writer, 400, b'{"error":"content-length"}', False)
                    return
                if length > MAX_BODY:
                    await self._reply(writer, 413, b'{"error":"body"}', False)
                    return
                try:
                    body = await reader.readexactly(length) if length else b""
                except asyncio.IncompleteReadError:
                    return  # the client closed mid-body
                keep = headers.get("connection", "keep-alive").lower() != "close"

                # a drain waits for requests being answered, not for idle
                # keep-alive connections parked in readuntil above
                self._inflight += 1
                try:
                    if method == "GET" and path == "/healthz":
                        code, payload = 200, {
                            "ok": True,
                            "model": type(self.service.model).__name__,
                            "batch_size": self.service.batch_size,
                            "beam_size": self.service.beam_size,
                            "frontend": "asyncio",
                            "stats": dict(self.service.server.stats),
                        }
                    elif method == "POST" and path == "/caption":
                        code, payload = await self._caption(
                            body, headers.get("content-type", ""))
                    else:
                        code, payload = 404, {"error": "unknown path"}
                    await self._reply(writer, code, json.dumps(payload).encode(), keep)
                finally:
                    self._inflight -= 1
                if not keep:
                    return
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    # ------------------------------------------------------------ lifecycle

    async def _serve(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(self._handle, host, port,
                                                  limit=_MAX_HEADER, backlog=512)
        self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        async with self._server:
            await self._server.serve_forever()

    def start(self, host: str = "0.0.0.0", port: int = 8080) -> None:
        """Run the loop in a daemon thread; returns once the socket listens
        (port 0 picks a free port: read ``self.port``). A bind error raises
        at once."""
        startup_error: list = []

        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            try:
                self._loop.run_until_complete(self._serve(host, port))
            except asyncio.CancelledError:
                pass
            except Exception as e:  # e.g. OSError(EADDRINUSE) from the bind
                startup_error.append(e)
                self._started.set()
            finally:
                # let the cancelled handlers run their finally blocks
                # (writer.wait_closed) before the loop closes
                try:
                    pending = asyncio.all_tasks(self._loop)
                    if pending:
                        self._loop.run_until_complete(asyncio.wait(pending, timeout=5))
                except Exception:
                    pass
                self._loop.close()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError("asyncio front end failed to start")
        if startup_error:
            raise RuntimeError(
                f"asyncio front end failed to start: {startup_error[0]}") from startup_error[0]

    def stop(self, drain: bool = False, timeout: float = 30.0) -> None:
        """Stop the front end.

        drain=False: cancel everything at once. drain=True (SIGTERM): close
        the listener (no new connections) and stop admitting requests on
        open ones, wait up to ``timeout`` s for the requests being answered,
        then cancel what is left (idle keep-alive connections are cut
        without a response, which HTTP/1.1 clients take as a normal close).
        """
        if self._loop is None:
            return
        if drain:
            drained = threading.Event()

            async def _drain():
                self._draining = True
                if self._server is not None:
                    # not wait_closed(): from Python 3.12.1 it waits for
                    # every connection, so one idle keep-alive client would
                    # hold the drain for the whole timeout
                    self._server.close()
                deadline = self._loop.time() + timeout
                while self._inflight and self._loop.time() < deadline:
                    await asyncio.sleep(0.01)
                drained.set()

            try:
                fut = asyncio.run_coroutine_threadsafe(_drain(), self._loop)
                drained.wait(timeout=timeout + 1)
                fut.cancel()
            except RuntimeError:  # the loop is already closing
                pass

        def shutdown():
            for task in asyncio.all_tasks(self._loop):
                task.cancel()

        try:
            self._loop.call_soon_threadsafe(shutdown)
        except RuntimeError:
            pass
        self._thread.join(timeout=10)


def run_server_async(service, host: str = "0.0.0.0", port: int = 8080) -> AsyncCaptionFrontend:
    """Start the asyncio front end; returns the running front end."""
    fe = AsyncCaptionFrontend(service)
    fe.start(host, port)
    return fe
