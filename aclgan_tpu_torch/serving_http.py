"""Minimal HTTP serving front (stdlib + Pillow) over the serving stack.

Port of `aclgan_tpu/serving_http.py`. `http.server` threads feed an
`AsyncTranslator`, whose worker coalesces concurrent requests into device
batches, so HTTP concurrency turns into batched kernel launches.

    python -m aclgan_tpu_torch.serving_http --config C --checkpoint gen.pt
    python -m aclgan_tpu_torch.serving_http --artifact m2f.aclt --port 8000
    (add --device cpu to run without a card)

    POST /translate   image file body (anything Pillow opens) -> JPEG response
                      optional header X-Style: comma-separated style_dim
                      floats (default: a fresh random style per request)
    GET  /healthz     JSON {"status": "ok", "batch_size", "size", "style_dim"}

Pillow decodes the bodies and encodes the replies; without it the server
raises at start. The JAX front's `bound_transfer_journal` is TPU-only and
has no counterpart here.
"""

from __future__ import annotations

import argparse
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from aclgan_tpu_torch.serving import AsyncTranslator


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("serving_http needs Pillow to decode request bodies and "
                           "encode JPEG replies; install Pillow") from e
    return Image


class TranslateHandler(BaseHTTPRequestHandler):
    # set by make_server(): the shared AsyncTranslator + metadata
    server_ctx = None

    def log_message(self, fmt, *args):  # quiet by default; --verbose restores
        if self.server_ctx.get("verbose"):
            super().log_message(fmt, *args)

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, obj) -> None:
        self._reply(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        if self.path == "/healthz":
            self._reply_json(200, {"status": "ok", **self.server_ctx["meta"]})
        else:
            self._reply_json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path != "/translate":
            self._reply_json(404, {"error": f"unknown path {self.path}"})
            return
        Image = self.server_ctx["Image"]
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length <= 0:
                raise ValueError("empty request body")
            img = Image.open(io.BytesIO(self.rfile.read(length))).convert("RGB")
            style = None
            if self.headers.get("X-Style"):
                style = np.asarray(
                    [float(v) for v in self.headers["X-Style"].split(",")],
                    np.float32)
        except Exception as e:
            self._reply_json(400, {"error": f"bad request: {e}"})
            return
        try:
            out = self.server_ctx["srv"].submit(
                np.asarray(img, np.uint8), style=style).result(
                timeout=self.server_ctx["timeout_s"])
            buf = io.BytesIO()
            Image.fromarray(out).save(buf, format="JPEG", quality=95)
            self._reply(200, buf.getvalue(), "image/jpeg")
        except Exception as e:  # bad style shape, device error, timeout
            self._reply_json(400, {"error": str(e)})


def make_server(translator, host: str = "127.0.0.1", port: int = 8000,
                timeout_s: float = 120.0, verbose: bool = False,
                max_wait_ms: float = 5.0) -> ThreadingHTTPServer:
    """Wrap any translator (Translator / BucketedTranslator /
    ExportedTranslator) in a ready-to-`serve_forever` HTTP server."""
    image_mod = _pil_image()
    srv = AsyncTranslator(translator, max_wait_ms=max_wait_ms)
    meta = {
        "batch_size": translator.batch_size,
        "size": getattr(translator, "size", None),
        "style_dim": srv.style_dim,
    }

    class Handler(TranslateHandler):
        server_ctx = {"srv": srv, "meta": meta, "timeout_s": timeout_s,
                      "verbose": verbose, "Image": image_mod}

    class _Server(ThreadingHTTPServer):
        # socketserver's default listen backlog is 5; a burst of clients
        # opening connections at once (48 closed-loop clients) overflows it
        # and the kernel resets the excess — raise it to a serving depth.
        request_queue_size = 128

    httpd = _Server((host, port), Handler)
    httpd.aclgan_async = srv  # for shutdown()
    return httpd


def server_from_argv(argv=None) -> ThreadingHTTPServer:
    """Parse `main`'s flags and build its server (not yet serving)."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, help="config yaml (with --checkpoint)")
    p.add_argument("--checkpoint", type=str, help="gen .pt or .msgpack")
    p.add_argument("--artifact", type=str, help="exported artifact instead")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch", type=int, default=8,
                   help="device batch (checkpoint mode)")
    p.add_argument("--a2b", type=int, default=1)
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="request-coalescing latency window")
    p.add_argument("--verbose", action="store_true")
    opts = p.parse_args(argv)

    if opts.artifact:
        from aclgan_tpu_torch.export import ExportedTranslator

        translator = ExportedTranslator(opts.artifact, device=opts.device)
    elif opts.config and opts.checkpoint:
        from aclgan_tpu_torch.serving import Translator

        translator = Translator(opts.config, opts.checkpoint, a2b=bool(opts.a2b),
                                batch_size=opts.batch, device=opts.device)
    else:
        p.error("need --artifact, or --config with --checkpoint")
    return make_server(translator, opts.host, opts.port, verbose=opts.verbose,
                       max_wait_ms=opts.max_wait_ms)


def main(argv=None):
    httpd = server_from_argv(argv)
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port} (POST /translate, GET /healthz)",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        httpd.aclgan_async.close(drain=False)


if __name__ == "__main__":
    main()
