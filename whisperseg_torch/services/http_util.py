"""Minimal HTTP service toolkit on the standard library (the port of
``whisperseg_tpu/services/http_util.py``): a threading HTTP server with
path -> handler routing, JSON responses with their key order kept, CORS
headers, and multipart/form-data parsing.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple


class Request:
    def __init__(self, handler: "_Handler"):
        self.method = handler.command
        self.path = handler.path.split("?")[0]
        self.headers = handler.headers
        length = int(handler.headers.get("Content-Length", 0) or 0)
        self.body = handler.rfile.read(length) if length else b""
        self._json = None
        self._form: Optional[Dict[str, bytes]] = None
        self._files: Optional[Dict[str, bytes]] = None

    @property
    def json(self):
        if self._json is None and self.body:
            self._json = json.loads(self.body)
        return self._json or {}

    def _parse_multipart(self):
        if self._form is not None:
            return
        self._form, self._files = {}, {}
        ctype = self.headers.get("Content-Type", "")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            if ctype.startswith("application/x-www-form-urlencoded"):
                from urllib.parse import parse_qsl

                for k, v in parse_qsl(self.body.decode()):
                    self._form[k] = v.encode()
            return
        boundary = m.group(1).encode()
        for part in self.body.split(b"--" + boundary):
            # Remove exactly the ONE leading CRLF that follows the boundary
            # line and the ONE trailing CRLF that precedes the next boundary.
            # NEVER .strip() here: a binary payload (WAV/FLAC/zip) whose real
            # first/last bytes are whitespace-class (0x09-0x0D, 0x20) would
            # lose data bytes, truncating the upload intermittently.
            if part.startswith(b"\r\n"):
                part = part[2:]
            elif part.startswith(b"\n"):
                part = part[1:]
            if part.endswith(b"\r\n"):
                part = part[:-2]
            elif part.endswith(b"\n"):
                part = part[:-1]
            if not part or part == b"--":
                continue
            if b"\r\n\r\n" in part:
                head, _, payload = part.partition(b"\r\n\r\n")
            else:
                head, _, payload = part.partition(b"\n\n")
            disp = b""
            for line in head.split(b"\r\n"):
                if line.lower().startswith(b"content-disposition"):
                    disp = line
            name_m = re.search(rb'name="([^"]*)"', disp)
            if not name_m:
                continue
            name = name_m.group(1).decode()
            if re.search(rb'filename="', disp):
                self._files[name] = payload
            else:
                self._form[name] = payload

    @property
    def form(self) -> Dict[str, bytes]:
        self._parse_multipart()
        return self._form or {}

    @property
    def files(self) -> Dict[str, bytes]:
        self._parse_multipart()
        return self._files or {}

    def form_get(self, key, default=None, type=None):
        v = self.form.get(key)
        if v is None:
            return default
        v = v.decode()
        if type is not None:
            try:
                return type(v)
            except ValueError:
                return default
        return v


Handler = Callable[[Request], Tuple[dict, int]]


class JsonHTTPServer:
    """Route registry + ThreadingHTTPServer wrapper."""

    def __init__(self):
        self.routes: Dict[Tuple[str, str], Handler] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None

    def route(self, path: str, methods=("GET",)):
        def deco(fn):
            for m in methods:
                self.routes[(m, path)] = fn
            return fn

        return deco

    def make_handler(self):
        routes = self.routes

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _send(self, payload: dict, code: int):
                body = json.dumps(payload, sort_keys=False).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Access-Control-Allow-Headers", "*")
                self.send_header("Access-Control-Allow-Methods", "*")
                self.end_headers()
                self.wfile.write(body)

            def _dispatch(self):
                handler = routes.get((self.command, self.path.split("?")[0]))
                if handler is None:
                    self._send({"error": "not found"}, 404)
                    return
                try:
                    req = Request(self)
                    payload, code = handler(req)
                except Exception as e:  # robust service: never crash the worker
                    payload, code = {"error": f"{type(e).__name__}: {e}"}, 500
                self._send(payload, code)

            def do_GET(self):
                self._dispatch()

            def do_POST(self):
                self._dispatch()

            def do_OPTIONS(self):
                self._send({}, 200)

        return _Handler

    def serve(self, host: str, port: int, background: bool = False):
        self._httpd = ThreadingHTTPServer((host, port), self.make_handler())
        if background:
            t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            t.start()
            return self._httpd
        self._httpd.serve_forever()

    def shutdown(self):
        """Stop serving and close the listening socket."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
