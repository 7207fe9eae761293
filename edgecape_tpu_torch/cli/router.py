"""Multi-replica router of the port: context-sticky load balancing over
N servers of cli/serve.py (one per card or host) behind one endpoint; a
copy of router.py, held equal to it by tests/test_torch_router.py.

Support contexts are DEVICE-RESIDENT on the replica that computed them,
so routing is sticky: every /predict for a context_id goes to the
replica that registered it. The router speaks exactly the server's API.

  POST /support        -> least-loaded LIVE replica; the returned
                          context_id is pinned to it
  POST /predict        -> the pinned replica (503 "context lost" if it
  POST /predict_batch     died or was reloaded; client re-registers)
  POST /reload         -> ROLLING fan-out: one replica at a time, each
                          must come back healthy before the next is
                          swapped, so serving capacity never hits zero
  GET  /healthz        -> aggregate + per-replica status

Replicas are probed every --probe-interval seconds; a dead replica's
contexts are invalidated (its device tensors are gone) and it rejoins
the pool when its /healthz answers again.

Stdlib-only, like the server. Run:
  python -m edgecape_tpu_torch.cli.serve --port 8301 &
  python -m edgecape_tpu_torch.cli.serve --port 8302 &
  python -m edgecape_tpu_torch.cli.router \\
      --replicas http://127.0.0.1:8301,http://127.0.0.1:8302
"""

from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class ReplicaHTTPError(Exception):
    """The replica answered with an HTTP error status: an application-
    level rejection from a LIVE replica (transport worked). Deliberately
    NOT a urllib.error.URLError subclass — HTTPError is, and letting it
    reach the (URLError, OSError) transport-failure handlers marked a
    healthy replica dead on any routine 400 (e.g. the unknown-context
    window between a replica-side /reload and the router's unpin)."""

    def __init__(self, status: int, body: dict):
        super().__init__(
            f"replica returned {status}: {body.get('error', body)}")
        self.status = status
        self.body = body


class Replica:
    """One backend server endpoint + its liveness/load bookkeeping."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.alive = True
        self.inflight = 0
        self.consecutive_failures = 0
        self.lock = threading.Lock()

    def request(self, path: str, payload: dict | None = None,
                timeout: float = 600.0) -> dict:
        """Forward one call; raises urllib errors on transport failure."""
        if payload is None:
            req = urllib.request.Request(self.url + path)
        else:
            body = json.dumps(payload).encode()
            req = urllib.request.Request(
                self.url + path, data=body,
                headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read())
            except Exception:  # noqa: BLE001 — non-json error page
                body = {"error": str(e.reason)}
            raise ReplicaHTTPError(e.code, body) from e


class Router:
    """Context-sticky routing table + replica pool (thread-safe)."""

    def __init__(self, replicas: list[str], probe_interval: float = 5.0,
                 dead_after: int = 2):
        self.replicas = [Replica(u) for u in replicas]
        self.routes: dict[str, Replica] = {}   # context_id -> replica
        self.lock = threading.Lock()
        self.probe_interval = probe_interval
        self.dead_after = dead_after
        self.stats = {"routed": 0, "failovers": 0, "rolling_reloads": 0}
        self._stop = threading.Event()
        self._prober = threading.Thread(target=self._probe_loop,
                                        daemon=True)
        if probe_interval > 0:
            self._prober.start()

    def close(self):
        self._stop.set()

    # ---- liveness ----------------------------------------------------

    def _mark_dead(self, rep: Replica):
        invalidated = []
        with self.lock:
            rep.alive = False
            for cid, r in list(self.routes.items()):
                if r is rep:
                    invalidated.append(cid)
                    del self.routes[cid]
            if invalidated:
                self.stats["failovers"] += 1
        return invalidated

    def _probe_one(self, rep: Replica):
        try:
            out = rep.request("/healthz", timeout=5.0)
            ok = bool(out.get("ok"))
        except Exception:  # noqa: BLE001 — any transport error = down
            ok = False
        if ok:
            with self.lock:
                rep.consecutive_failures = 0
                rep.alive = True
        else:
            with self.lock:
                rep.consecutive_failures += 1
                dead = rep.consecutive_failures >= self.dead_after
            if dead:
                self._mark_dead(rep)

    def _probe_loop(self):
        while not self._stop.wait(self.probe_interval):
            for rep in self.replicas:
                self._probe_one(rep)

    # ---- routing -----------------------------------------------------

    def _pick_for_support(self) -> Replica:
        """Least outstanding requests among live replicas; ties broken by
        registry pressure (fewer pinned contexts first)."""
        with self.lock:
            live = [r for r in self.replicas if r.alive]
            if not live:
                raise LookupError("no live replicas")
            pinned = {id(r): 0 for r in live}
            for rep in self.routes.values():
                if id(rep) in pinned:
                    pinned[id(rep)] += 1
            return min(live, key=lambda r: (r.inflight, pinned[id(r)]))

    def _forward(self, rep: Replica, path: str, payload: dict) -> dict:
        with self.lock:
            rep.inflight += 1
        try:
            return rep.request(path, payload)
        finally:
            with self.lock:
                rep.inflight -= 1
                self.stats["routed"] += 1

    def support(self, payload: dict) -> dict:
        rep = self._pick_for_support()
        try:
            # through _forward so inflight counting covers /support — the
            # most expensive call; otherwise concurrent registrations all
            # see inflight=0 and pile onto the same replica
            out = self._forward(rep, "/support", payload)
        except (urllib.error.URLError, OSError) as e:
            self._mark_dead(rep)
            raise LookupError(
                f"replica {rep.url} failed during /support ({e}); "
                "retry — the next attempt routes elsewhere") from e
        cid = out.get("context_id")
        if cid:
            with self.lock:
                self.routes[cid] = rep
        return out

    def predict(self, path: str, payload: dict) -> dict:
        cid = payload.get("context_id", "")
        with self.lock:
            rep = self.routes.get(cid)
        if rep is None or not rep.alive:
            # the context's device tensors lived on a replica that died
            # or was reloaded; the client must re-register (same contract
            # as a single server after /reload)
            raise LookupError("context lost; re-register the support")
        try:
            return self._forward(rep, path, payload)
        except ReplicaHTTPError as e:
            if e.status == 400:
                # the replica is alive but no longer knows this context
                # (its /reload landed between our routing lookup and the
                # forward): unpin and hand the client the re-register
                # contract — NOT a liveness event
                with self.lock:
                    self.routes.pop(cid, None)
                raise LookupError(
                    "context lost; re-register the support") from e
            raise
        except (urllib.error.URLError, OSError) as e:
            self._mark_dead(rep)
            raise LookupError(
                f"replica {rep.url} died mid-request ({e}); context lost; "
                "re-register the support") from e

    # ---- rolling reload ----------------------------------------------

    def rolling_reload(self, payload: dict) -> dict:
        """Swap checkpoints one replica at a time. Each replica must
        answer /healthz ok after its /reload before the next one is
        touched, so aggregate capacity never reaches zero. Contexts
        pinned to a reloaded replica are invalidated (the server drops
        them on its side)."""
        results, dropped = {}, 0
        with self.lock:
            live = [r for r in self.replicas if r.alive]
        if not live:
            raise LookupError("no live replicas")
        for rep in live:
            try:
                out = rep.request("/reload", payload)
            except ReplicaHTTPError as e:
                # reload rejected (e.g. checkpoint structure mismatch):
                # the replica keeps serving its CURRENT weights — record
                # the error, do not mark it dead, do not unpin
                results[rep.url] = {"error": str(e), "status": e.status}
                continue
            except (urllib.error.URLError, OSError) as e:
                self._mark_dead(rep)
                results[rep.url] = {"error": str(e)}
                continue
            dropped += int(out.get("contexts_dropped", 0))
            results[rep.url] = out
            # the replica's contexts are gone — unpin before routing more
            with self.lock:
                for cid, r in list(self.routes.items()):
                    if r is rep:
                        del self.routes[cid]
            self._probe_one(rep)   # must be healthy before the next swap
            with self.lock:
                healthy = rep.alive
            if not healthy:
                results[rep.url]["post_reload_health"] = "failed"
        with self.lock:
            self.stats["rolling_reloads"] += 1
        return {"ok": all("error" not in r for r in results.values()),
                "contexts_dropped": dropped, "replicas": results}

    def healthz(self) -> dict:
        per = []
        with self.lock:
            routes = len(self.routes)
            for rep in self.replicas:
                per.append({"url": rep.url, "alive": rep.alive,
                            "inflight": rep.inflight})
            stats = dict(self.stats)
        return {"ok": any(r["alive"] for r in per), "replicas": per,
                "contexts": routes, "stats": stats}


def make_handler(router: Router):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, router.healthz())
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                if self.path == "/support":
                    self._reply(200, router.support(payload))
                elif self.path in ("/predict", "/predict_batch"):
                    self._reply(200, router.predict(self.path, payload))
                elif self.path == "/reload":
                    self._reply(200, router.rolling_reload(payload))
                else:
                    self._reply(404, {"error": "not found"})
            except LookupError as e:   # routing-level: retryable by client
                self._reply(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — report to client
                self._reply(400, {"error": str(e)})

        def log_message(self, *args):
            pass

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edgecape_tpu_torch.cli.router",
        description="EdgeCape multi-replica router (PyTorch + CUDA port)")
    p.add_argument("--replicas", required=True,
                   help="comma-separated base URLs of cli/serve.py servers")
    p.add_argument("--port", type=int, default=8300)
    p.add_argument("--probe-interval", type=float, default=5.0)
    args = p.parse_args(argv)
    router = Router([u for u in args.replicas.split(",") if u],
                    probe_interval=args.probe_interval)
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 make_handler(router))
    print(f"routing {len(router.replicas)} replicas on :{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
