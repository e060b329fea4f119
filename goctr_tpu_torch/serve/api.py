"""HTTP scoring API (port of goctr_tpu/serve/api.py).

Endpoint/schema parity with the reference gin server
(go-ctr recommend/api.go):
  POST {api_path}            {"userId": N, "itemIdList": [..]} →
                             {"itemScoreList": [{"itemId","score"}...]}
  GET  /service/useritems    ?page=&size= → users feature overview
  GET  /service/items        ?page=&size= → items feature overview
  GET  /service/overview     dashboard counts
  GET  /service/featuredist  ?kind=items|users → per-feature histograms
  GET  /                     a minimal page (the dashboard is not ported)

Ranking goes through the predictor's `rank_direct` (serve/scorer.py
SparseRankPredictor: device-resident table, micro-batched). The
host-assembly `Rank` path of the JAX server comes with the port of
recommend/; until then a predictor without `rank_direct` gets 501. Item
ids outside the table get 400, naming them (the table has no row to score
them: JAX's server answers a bare NaN for an id past the table). The
/service/* endpoints call the predictor's `rec_sys` duck-typed, with
`None` in place of the JAX package's recommend Context.

stdlib http.server; ThreadingHTTPServer handles each request on its own
thread, and the MicroBatcher coalesces concurrent requests.
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from goctr_tpu_torch.serve.scorer import ItemIdsOutsideTable

log = logging.getLogger(__name__)

_INDEX_HTML = "<html><body>goctr_tpu_torch</body></html>"


class _Server(ThreadingHTTPServer):
    # listen backlog: the stdlib default of 5 drops the connects of a burst
    # of concurrent clients, which then wait out a 1 s SYN retransmit
    request_queue_size = 128


class RecApiServer:

    def __init__(self, predictor, api_path: str = "/api/v1/recommend",
                 host: str = "0.0.0.0", port: int = 8080):
        self.predictor = predictor
        self.api_path = api_path
        self.host = host
        self.port = port
        self._httpd: _Server | None = None
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ handlers --
    def _rank(self, body: dict) -> tuple[int, dict]:
        user_id = body.get("userId")
        item_ids = body.get("itemIdList") or []
        if not isinstance(user_id, int):
            return 400, {"error": "userId must be an integer"}
        if not item_ids:
            return 400, {"error": "itemIdList is empty"}   # api.go:116
        if not hasattr(self.predictor, "rank_direct"):
            return 501, {"error": "this predictor has no rank_direct; the "
                                  "host-assembly ranking path (recommend/) "
                                  "is not ported yet"}
        try:
            pairs = self.predictor.rank_direct(user_id,
                                               [int(i) for i in item_ids])
        except ItemIdsOutsideTable as e:
            return 400, {"error": str(e), "itemIdsOutsideTable": e.ids}
        return 200, {"itemScoreList": [
            {"itemId": i, "score": s} for i, s in pairs]}

    def _overview(self, which: str, offset: int, size: int,
                  opts: dict) -> tuple[int, object]:
        rs = getattr(self.predictor, "rec_sys", None)
        if which == "useritems":
            if not hasattr(rs, "get_users_feature_overview"):
                return 200, "do not support feature overview"
            return 200, rs.get_users_feature_overview(None, offset, size,
                                                      opts)
        if which == "items":
            if not hasattr(rs, "get_items_feature_overview"):
                return 200, "do not support item overview"
            return 200, rs.get_items_feature_overview(None, offset, size,
                                                      opts)
        if which == "featuredist":
            if not hasattr(rs, "get_feature_distributions"):
                return 200, "do not support feature distributions"
            kind = (opts.get("kind") or ["items"])[0]
            return 200, rs.get_feature_distributions(None, kind=kind)
        if not hasattr(rs, "get_dashboard_overview"):
            return 200, "do not support overview"
        return 200, rs.get_dashboard_overview(None)

    # -------------------------------------------------------------- server --
    def _make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug("http: " + fmt, *args)

            def _send(self, code: int, payload, ctype="application/json"):
                data = (payload.encode() if ctype == "text/html"
                        else json.dumps(payload).encode())
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                url = urlparse(self.path)
                q = parse_qs(url.query)
                try:
                    size = int(q.get("size", ["0"])[0] or 0)
                    page = int(q.get("page", ["0"])[0] or 0)
                except ValueError as e:
                    self._send(400, {"error": f"bad request: {e}"})
                    return
                offset = (page - 1) * size if size > 0 and page > 0 else 0
                if url.path.startswith("/service/"):
                    which = url.path.rsplit("/", 1)[-1]
                    try:
                        code, payload = server_self._overview(
                            which, offset, size, q)
                    except Exception as e:
                        log.exception("overview failed")
                        code, payload = 500, {"error": str(e)}
                    self._send(code, payload)
                elif url.path in ("/", "/index.html"):
                    self._send(200, _INDEX_HTML, "text/html")
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                url = urlparse(self.path)
                if url.path != server_self.api_path:
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(n) or b"{}")
                except ValueError as e:
                    self._send(400, {"error": f"bad request: {e}"})
                    return
                if not isinstance(body, dict):
                    self._send(400, {"error": "body must be a JSON object"})
                    return
                try:
                    code, payload = server_self._rank(body)
                except Exception as e:
                    log.exception("rank failed")
                    code, payload = 500, {"error": str(e)}
                self._send(code, payload)

        return Handler

    def start(self, background: bool = False) -> "RecApiServer":
        self._httpd = _Server((self.host, self.port), self._make_handler())
        self.port = self._httpd.server_address[1]   # resolve port 0
        if background:
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            daemon=True)
            self._thread.start()
        else:
            log.info("serving on %s:%d", self.host, self.port)
            self._httpd.serve_forever()
        return self

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
