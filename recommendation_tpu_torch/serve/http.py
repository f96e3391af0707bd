"""Minimal HTTP front end for :class:`RecommenderService` (stdlib only).
A copy of ``recommendation_tpu/serve/http.py``.

  GET /healthz                         -> {"status": "ok", ...}
  GET /recommend?user=<id>&k=10        -> {"user": ..., "items": [...]}
  POST /recommend {"users": [...], "k": 10}  -> batch form

No pip dependencies (environment constraint); for production front ends put
a real server in front — this endpoint is the reference wiring of query →
device MIPS top-k.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from recommendation_tpu_torch.serve.service import RecommenderService


def _make_handler(service: RecommenderService):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "n_users": service.data.user_num,
                    "n_items": service.data.item_num,
                })
                return
            if url.path == "/recommend":
                q = parse_qs(url.query)
                user = q.get("user", [None])[0]
                if user is None:
                    self._send(400, {"error": "missing 'user' parameter"})
                    return
                try:
                    k = int(q.get("k", ["10"])[0])
                except ValueError:
                    self._send(400, {"error": "'k' must be an integer"})
                    return
                items = service.recommend([user], k=k)[0]
                if items is None:
                    self._send(404, {"error": f"unknown user {user!r}"})
                    return
                self._send(200, {"user": user, "items": items})
                return
            self._send(404, {"error": "unknown path"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/recommend":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                users = req["users"]
                k = int(req.get("k", 10))
            except (json.JSONDecodeError, KeyError, ValueError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            results = service.recommend(users, k=k)
            self._send(200, {
                "results": [
                    {"user": u, "items": r} for u, r in zip(users, results)
                ]
            })

    return Handler


def serve_http(
    service: RecommenderService, host: str = "127.0.0.1", port: int = 8080,
    background: bool = False, batching: bool = True,
):
    """Start the HTTP server. ``background=True`` returns the server object
    (call ``.shutdown()``); otherwise blocks. ``batching`` (default on)
    micro-batches concurrent requests into one device top-k per wave
    (`serve/batching.py`)."""
    if batching:
        service.enable_batching()
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    if background:
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return server
