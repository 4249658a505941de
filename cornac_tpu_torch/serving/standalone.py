"""Dependency-free model server (stdlib http.server), a port of
``cornac_tpu/serving/standalone.py``. Run:

    MODEL_PATH=... MODEL_CLASS=cornac_tpu_torch.models.TPUExactANN \
        python -m cornac_tpu_torch.serving.standalone [--port 5000]
"""

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlparse

from .core import handle_evaluate, handle_feedback, handle_recommend, load_model


def make_handler(model, train_set):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, payload, status):
            if isinstance(payload, str):
                body = payload.encode()
                ctype = "text/plain"
            else:
                body = json.dumps(payload).encode()
                ctype = "application/json"
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/recommend":
                params = dict(parse_qsl(url.query))
                self._send(*handle_recommend(model, train_set, params))
            else:
                self._send("Not found", 404)

        def do_POST(self):
            url = urlparse(self.path)
            params = dict(parse_qsl(url.query))
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length) if length else b""
            if url.path == "/feedback":
                self._send(*handle_feedback(params))
            elif url.path == "/evaluate":
                try:
                    query = json.loads(raw) if raw else {}
                except json.JSONDecodeError:
                    self._send("Invalid JSON body", 400)
                    return
                self._send(*handle_evaluate(model, train_set, query))
            else:
                self._send("Not found", 404)

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(port=5000, host="127.0.0.1"):
    model, train_set = load_model(".")
    server = ThreadingHTTPServer((host, port), make_handler(model, train_set))
    print(f"Serving {type(model).__name__} on http://{host}:{port}")
    server.serve_forever()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--host", default="127.0.0.1")
    args = parser.parse_args()
    serve(port=args.port, host=args.host)
