"""HTTP serving shared by the metrics and admission endpoints.

One place owns the ThreadingHTTPServer lifecycle (daemon serve_forever
thread, shutdown AND server_close — shutdown alone leaks the listening
socket fd across serve/stop cycles). Binds ALL interfaces by default:
kubelet httpGet probes and Prometheus scrapes connect to the POD IP, so a
loopback-only bind silently fails every shipped probe (callers wanting
loopback pass host="127.0.0.1")."""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class QuietHandler(BaseHTTPRequestHandler):
    """Request handler base for internal endpoints: silenced access log +
    one-call responses."""

    def reply(self, code: int, body: bytes, ctype: str = "text/plain") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # quiet
        pass


def serve_http(handler_cls, port: int = 0, host: str = "",
               tls_dir: str = "") -> ThreadingHTTPServer:
    """Bind host:port ("" = all interfaces, 0 = ephemeral port) and serve
    on a daemon thread. The bound port is ``server.server_address[1]``.

    ``tls_dir``: directory holding ``tls.crt`` + ``tls.key`` (the shape a
    mounted kubernetes.io/tls Secret presents) — non-empty wraps the
    listener in TLS, which is how the webhook endpoint serves the
    apiserver (clientConfig.service is always HTTPS)."""
    server = ThreadingHTTPServer((host, port), handler_cls)
    if tls_dir:
        import os
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(
            os.path.join(tls_dir, "tls.crt"), os.path.join(tls_dir, "tls.key")
        )
        server.socket = ctx.wrap_socket(server.socket, server_side=True)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


# Backwards-compatible alias (the earlier name; loopback was the old
# default and broke in-cluster probes/scrapes).
def serve_on_loopback(handler_cls, port: int = 0) -> ThreadingHTTPServer:
    return serve_http(handler_cls, port, host="127.0.0.1")


def stop_server(server: Optional[ThreadingHTTPServer]) -> None:
    if server is not None:
        server.shutdown()
        server.server_close()
