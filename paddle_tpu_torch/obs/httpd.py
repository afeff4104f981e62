"""Minimal /metrics HTTP endpoint (Prometheus scrape target; counterpart
of paddle_tpu/obs/httpd.py).

Start one next to a ``PredictorServer``; operators who prefer the wire
protocol can send the ``metrics`` command (cmd 6) on the serving socket
instead. Both render the same registry.
"""
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import prometheus


class MetricsServer:
    """Threaded HTTP server answering GET /metrics with the text
    exposition of ``registry`` (default: the process registry)."""

    def __init__(self, port=0, host="127.0.0.1", registry=None):
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = prometheus.render(srv._registry).encode("utf-8")
                except Exception as e:  # noqa: BLE001 — scrape must not 500 silently
                    self.send_error(500, str(e)[:200])
                    return
                self.send_response(200)
                self.send_header("Content-Type", prometheus.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes are not access-log news
                pass

        self._registry = registry
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="obs-metrics-http",
                                        daemon=True)
        self._thread.start()

    def close(self):
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass
        self._thread.join(5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
