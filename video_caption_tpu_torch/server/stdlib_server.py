"""HTTP server on the standard library (counterpart of
video_caption_tpu/server/stdlib_server.py): POST /infer, POST /api/v1/infer,
GET /health (and /api/v1/health).

The port serves through it alone: fastapi and uvicorn are installed on
neither machine it runs on. Status codes as the JAX package's:
FileNotFoundError -> 400, a payload that does not fit the schema
(ValueError, TypeError) -> 422, an unknown route -> 404, anything else ->
500.
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

log = logging.getLogger(__name__)


def _infer_payload(body) -> dict:
    from video_caption_tpu_torch.server.schemas import InferRequest
    from video_caption_tpu_torch.server.services.inference_service import INFERENCE_SERVICE

    return INFERENCE_SERVICE.infer(InferRequest.from_payload(body))


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.info("%s - %s", self.address_string(), fmt % args)

    def do_GET(self):
        if self.path.rstrip("/") in ("", "/api/v1") or self.path in ("/health", "/api/v1/health"):
            self._send(200, {"status": "ok"})
        else:
            self._send(404, {"detail": "not found"})

    def do_POST(self):
        if self.path not in ("/infer", "/api/v1/infer"):
            self._send(404, {"detail": "not found"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            self._send(200, _infer_payload(body))
        except FileNotFoundError as err:
            self._send(400, {"detail": str(err)})
        except (ValueError, TypeError) as err:
            self._send(422, {"detail": str(err)})
        except Exception as err:  # the server keeps serving; the client gets a 500
            log.exception("inference failed")
            self._send(500, {"detail": str(err)})


class _Server(ThreadingHTTPServer):
    # socketserver's default listen backlog (request_queue_size) is 5: under
    # bursty load the SYN queue overflows and clients see connection resets
    request_queue_size = 128


class StdlibServer:
    """Threaded HTTP server; ``serve_forever`` blocks, ``start`` runs it in a
    daemon thread (tests, chip_smoke.py)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8001):
        self.httpd = _Server((host, port), _Handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StdlibServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        log.info("stdlib server listening on %s:%d", self.host, self.port)
        self.httpd.serve_forever()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
