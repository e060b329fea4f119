"""HTTP scoring API + dashboard endpoints (port of goctr_tpu/serve/api.py).

Endpoint/schema parity with the reference gin server
(go-ctr recommend/api.go):
  POST {api_path}            {"userId": N, "itemIdList": [..]} →
                             {"itemScoreList": [{"itemId","score"}...]}
  GET  /service/useritems    ?page=&size= → users feature overview
  GET  /service/items        ?page=&size= → items feature overview
  GET  /service/overview     dashboard counts
  GET  /service/featuredist  ?kind=items|users → per-feature histograms
  GET  /                     the embedded dashboard page (serve/dashboard.html,
                             the port's copy of the JAX package's page)

Ranking: a predictor with `rank_direct` (serve/scorer.py
SparseRankPredictor: device-resident table, micro-batched) takes it, and
item ids outside its table get 400 naming them (the table has no row to
score them: JAX's server answers a bare NaN for an id past the table).
Any other predictor (recommend/rcmd.py Predictor, what Train returns) goes
through `Rank`: host assembly from its rec_sys, then its model's predict.
An unknown userId, or an unknown first item, gets 400 naming the id (JAX
answers 500). The /service/* endpoints call the predictor's `rec_sys`
duck-typed with a fresh `Context()`, as JAX's do.

stdlib http.server; ThreadingHTTPServer handles each request on its own
thread, and the MicroBatcher coalesces concurrent rank_direct requests.
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

from goctr_tpu_torch.recommend.rcmd import Context, Rank, UnknownIdError
from goctr_tpu_torch.serve.scorer import ItemIdsOutsideTable

log = logging.getLogger(__name__)

_DASHBOARD_HTML = Path(__file__).resolve().parent / "dashboard.html"


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
        item_ids = [int(i) for i in item_ids]
        if hasattr(self.predictor, "rank_direct"):
            try:
                pairs = self.predictor.rank_direct(user_id, item_ids)
            except ItemIdsOutsideTable as e:
                return 400, {"error": str(e),
                             "itemIdsOutsideTable": e.ids}
            return 200, {"itemScoreList": [
                {"itemId": i, "score": s} for i, s in pairs]}
        try:
            scores = Rank(Context(), self.predictor, user_id, item_ids)
        except UnknownIdError as e:
            return 400, {"error": str(e), e.kind: e.id}
        return 200, {"itemScoreList": [
            {"itemId": s.item_id, "score": s.score} for s in scores]}

    def _overview(self, which: str, offset: int, size: int,
                  opts: dict) -> tuple[int, object]:
        rs = getattr(self.predictor, "rec_sys", None)
        ctx = Context()
        if which == "useritems":
            if not hasattr(rs, "get_users_feature_overview"):
                return 200, "do not support feature overview"
            return 200, rs.get_users_feature_overview(ctx, offset, size, opts)
        if which == "items":
            if not hasattr(rs, "get_items_feature_overview"):
                return 200, "do not support item overview"
            return 200, rs.get_items_feature_overview(ctx, offset, size, opts)
        if which == "featuredist":
            if not hasattr(rs, "get_feature_distributions"):
                return 200, "do not support feature distributions"
            kind = (opts.get("kind") or ["items"])[0]
            return 200, rs.get_feature_distributions(ctx, kind=kind)
        if not hasattr(rs, "get_dashboard_overview"):
            return 200, "do not support overview"
        return 200, rs.get_dashboard_overview(ctx)

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
                    self._send(200, _DASHBOARD_HTML.read_text(), "text/html")
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


def start_http_api(predictor, path: str = "/api/v1/recommend",
                   addr: str = ":8080") -> None:
    """Blocking serve (StartHttpApi parity, api.go:27)."""
    host, _, port = addr.rpartition(":")
    server = RecApiServer(predictor, api_path=path, host=host or "0.0.0.0",
                          port=int(port))
    server.start(background=False)
