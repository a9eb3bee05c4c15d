"""Asyncio HTTP front end over the serving stack — the port's copy of
``repro.serve.frontend``.

Stdlib-only (``asyncio.start_server`` + hand-rolled HTTP/1.1 framing —
no web framework dependency): one event-loop thread owns every
``DistanceServer``/``ReplicaSet`` in the ``IndexRegistry``, so the
engines need no locks, and concurrent HTTP requests micro-batch exactly
like in-process callers — submit on arrival, a periodic pump task
flushes shape buckets on their deadlines.

On the card every kernel launch of the served batches therefore runs on
the loop thread (``start_background``), and each batch keeps its one
``host_read``: warm the servers up before starting the front end (their
constructors do), then leave all index work to the loop. The sync debug
mode of ``torch.cuda`` is process-wide, so a caller's mode "error"
holds on the loop thread too.

Lanes / endpoints:

  ``POST /query``   {"s", "t"} or {"pairs": [[s, t], ...]} (+"graph")
                    → {"answers": [...], "vid": ...}. Distances ride the
                    same μ-routed micro-batch path as in-process
                    serving; float32 answers round-trip JSON bitwise
                    (they leave the device as a host float32 array;
                    float32→float64 is exact, ``repr`` round-trips,
                    ``Infinity`` is legal in Python's JSON).
  ``POST /path``    {"s", "t"} → {"dist", "path", "valid"} via the
                    shortest-path lane (requires ``path_hop_caps``).
  ``POST /mutate``  {"ops": [{"kind", "u", "nbrs", "ws"}, ...]} →
                    {"vid"}: a §8.3 write batch through the versioned
                    COW lane; pending reads force-flush first, so a
                    sequential client observes the identical version
                    sequence as ``serve_readwrite_trace``.
  ``GET /stats``    aggregate + per-graph stats JSON (plus SLO state).
  ``GET /metrics``  Prometheus text exposition of the whole registry.
  ``GET /events``   Server-Sent Events: periodic ``metrics`` frames
                    (servers changed), live ``slo_alert`` events relayed
                    from the ``EventLog``, comment heartbeats when idle.
  ``GET /healthz``  liveness probe.

Observability: every request lands in ``http.requests`` (route/code)
and ``http.request_seconds``; an attached ``SLOEngine`` is stepped on
the pump cadence with the wall clock (its availability source reads the
``http.*`` counters, its latency source the ``serve.*`` histograms), so
burn-rate alerts fire while the service runs and stream out over
``/events``.
"""
from __future__ import annotations

import asyncio
import http.client
import json
import threading
import time

import numpy as np

from repro_torch.obs.registry import REGISTRY
from repro_torch.serve.versions import MutationOp

__all__ = ["ServiceFrontend", "HttpClient", "replay_http"]

_JSON_HDR = "application/json"
_SSE_HDR = "text/event-stream"
_PROM_HDR = "text/plain; version=0.0.4"


class _HttpError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class ServiceFrontend:
    """One process-wide HTTP front end over an ``IndexRegistry``.

    The loop thread is the sole owner of every registered server: HTTP
    handlers submit/await, the pump task flushes batch deadlines and
    steps the SLO engine. ``start_background()`` runs the loop in a
    daemon thread and returns the bound ``(host, port)`` — the test and
    ``launch/serve.py --mode http`` entry point.
    """

    def __init__(self, registry, *, slo=None, log=None, metrics=None,
                 host: str = "127.0.0.1", port: int = 0,
                 pump_interval_s: float = 0.002,
                 slo_interval_s: float = 0.05,
                 sse_interval_s: float = 0.2,
                 heartbeat_s: float = 2.0):
        self.index_registry = registry
        self.slo = slo
        self.log = log
        self.metrics_registry = metrics if metrics is not None else REGISTRY
        self.host = host
        self.port = int(port)
        self.pump_interval_s = float(pump_interval_s)
        self.slo_interval_s = float(slo_interval_s)
        self.sse_interval_s = float(sse_interval_s)
        self.heartbeat_s = float(heartbeat_s)
        self._t0 = time.monotonic()
        self._server = None
        self._loop = None
        self._thread = None
        self._pump_task = None
        self._waiters: dict = {}        # (graph, rid) -> Future
        self._next_slo = 0.0
        r = self.metrics_registry
        self._req_c = r.counter("http.requests",
                                "front-end requests by route and status")
        self._req_h = r.histogram("http.request_seconds",
                                  "front-end request wall time")
        self._sse_g = r.gauge("http.sse_clients",
                              "connected /events streams")

    # ------------------------------------------------------------ clock
    def _now(self) -> float:
        """Serving clock: wall seconds since front-end start (matches
        the trace-replay convention of a clock starting at 0)."""
        return time.monotonic() - self._t0

    # ------------------------------------------------------- lifecycle
    async def start(self):
        """Bind and start serving on the current event loop."""
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._pump_task = asyncio.ensure_future(self._pump_loop())
        if self.log is not None:
            self.log.log("frontend_start", ts=self._now(),
                         host=self.host, port=self.port,
                         graphs=self.index_registry.names())
        return self

    async def stop_async(self):
        if self._pump_task is not None:
            self._pump_task.cancel()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for srv in self._servers():
            srv.drain(self._now())
        self._deliver()

    def start_background(self):
        """Run the loop in a daemon thread; returns ``(host, port)``."""
        started = threading.Event()

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            loop.run_until_complete(self.start())
            started.set()
            loop.run_forever()
            loop.run_until_complete(self.stop_async())
            # cancel lingering keep-alive connection handlers before
            # the loop closes (they wait forever on the next request)
            pending = asyncio.all_tasks(loop)
            for t in pending:
                t.cancel()
            loop.run_until_complete(
                asyncio.gather(*pending, return_exceptions=True))
            loop.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="frontend")
        self._thread.start()
        if not started.wait(timeout=60):
            raise RuntimeError("front end failed to start")
        return self.host, self.port

    def stop(self):
        """Stop a ``start_background`` front end and join its thread."""
        if self._loop is not None and self._thread is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=30)
            self._thread = None

    # ------------------------------------------------------- pump task
    def _servers(self):
        return [self.index_registry.get(n)
                for n in self.index_registry.names()]

    def _deliver(self) -> None:
        """Resolve waiter futures whose results have landed."""
        done = []
        for key, fut in self._waiters.items():
            val = self.index_registry.get(key[0]).take_result(key[1])
            if val is not None:
                if not fut.done():
                    fut.set_result(val)
                done.append(key)
        for key in done:
            del self._waiters[key]

    async def _pump_loop(self):
        while True:
            now = self._now()
            for srv in self._servers():
                srv.pump(now)
            if self._waiters:
                self._deliver()
            if self.slo is not None and now >= self._next_slo:
                self.slo.step(now)
                self._next_slo = now + self.slo_interval_s
            await asyncio.sleep(self.pump_interval_s)

    async def _await_result(self, graph: str, srv, rid: int):
        """Wait for one submitted request (immediate on cache hits)."""
        val = srv.take_result(rid)
        if val is not None:
            return val
        fut = self._loop.create_future()
        self._waiters[(graph, rid)] = fut
        return await fut

    # ---------------------------------------------------- HTTP framing
    async def _handle_conn(self, reader, writer):
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                method, target, body = req
                keep = await self._dispatch(method, target, body, writer)
                if not keep:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    @staticmethod
    async def _read_request(reader):
        line = await reader.readline()
        if not line or line in (b"\r\n", b"\n"):
            return None
        try:
            method, target, _ = line.decode("latin-1").split(None, 2)
        except ValueError:
            return None
        length = 0
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin-1").partition(":")
            if name.strip().lower() == "content-length":
                length = int(value.strip())
        body = await reader.readexactly(length) if length else b""
        return method.upper(), target, body

    @staticmethod
    def _write_response(writer, code: int, content_type: str,
                        payload: bytes, extra: str = "") -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  500: "Internal Server Error"}.get(code, "OK")
        head = (f"HTTP/1.1 {code} {reason}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"{extra}Connection: keep-alive\r\n\r\n")
        writer.write(head.encode("latin-1") + payload)

    async def _dispatch(self, method, target, body, writer) -> bool:
        """Route one request; returns False to drop the connection
        (only the SSE stream, which owns it until the client leaves)."""
        path, _, query = target.partition("?")
        route = f"{method} {path}"
        t_start = time.monotonic()
        code = 200
        try:
            if route == "GET /events":
                await self._serve_sse(writer)
                return False
            payload, ctype = await self._route(method, path, query, body)
            self._write_response(writer, 200, ctype, payload)
        except _HttpError as e:
            code = e.code
            self._write_response(
                writer, e.code, _JSON_HDR,
                json.dumps({"error": str(e)}).encode())
        except Exception as e:           # noqa: BLE001 — 500, keep serving
            code = 500
            self._write_response(
                writer, 500, _JSON_HDR,
                json.dumps({"error": f"{type(e).__name__}: {e}"}).encode())
        await writer.drain()
        self._req_c.inc(1, route=path, code=str(code))
        self._req_h.observe(time.monotonic() - t_start, route=path)
        if self.slo is not None and "availability" in self.slo.specs:
            ok = code < 500
            self.slo.record("availability", self._now(),
                            good=int(ok), bad=int(not ok))
        return True

    async def _route(self, method, path, query, body):
        if method == "GET" and path == "/healthz":
            return self._json({"ok": True, "uptime_s": self._now()})
        if method == "GET" and path == "/stats":
            return self._json(self._stats())
        if method == "GET" and path == "/metrics":
            text = self.metrics_registry.render_prometheus()
            return text.encode(), _PROM_HDR
        if method == "POST" and path == "/query":
            return self._json(await self._query(self._body(body)))
        if method == "POST" and path == "/path":
            return self._json(await self._path(self._body(body)))
        if method == "POST" and path == "/mutate":
            return self._json(self._mutate(self._body(body)))
        raise _HttpError(404, f"no route {method} {path}")

    @staticmethod
    def _json(obj):
        return json.dumps(obj).encode(), _JSON_HDR

    @staticmethod
    def _body(raw: bytes) -> dict:
        if not raw:
            return {}
        try:
            out = json.loads(raw)
        except json.JSONDecodeError as e:
            raise _HttpError(400, f"bad JSON body: {e}")
        if not isinstance(out, dict):
            raise _HttpError(400, "body must be a JSON object")
        return out

    def _graph(self, body: dict):
        name = str(body.get("graph", "default"))
        try:
            return name, self.index_registry.get(name)
        except KeyError as e:
            raise _HttpError(404, str(e))

    # ------------------------------------------------------- endpoints
    async def _query(self, body: dict) -> dict:
        name, srv = self._graph(body)
        if "pairs" in body:
            pairs = [(int(s), int(t)) for s, t in body["pairs"]]
        elif "s" in body and "t" in body:
            pairs = [(int(body["s"]), int(body["t"]))]
        else:
            raise _HttpError(400, 'need "s"/"t" or "pairs"')
        now = self._now()
        vid = None if srv.versions is None else srv.versions.current.vid
        rids = [srv.submit(s, t, now) for s, t in pairs]
        srv.pump(self._now())
        answers = [float(np.float32(await self._await_result(name, srv, r)))
                   for r in rids]
        out = {"answers": answers}
        if vid is not None:
            out["vid"] = int(vid)
        return out

    async def _path(self, body: dict) -> dict:
        name, srv = self._graph(body)
        if "s" not in body or "t" not in body:
            raise _HttpError(400, 'need "s" and "t"')
        if not getattr(srv, "path_hop_caps", ()):
            raise _HttpError(400, f"graph {name!r} serves no path lane "
                                  "(built without path_hop_caps)")
        rid = srv.submit_path(int(body["s"]), int(body["t"]), self._now())
        srv.pump(self._now())
        ans = await self._await_result(name, srv, rid)
        return {"dist": float(np.float32(ans.dist)),
                "path": [int(v) for v in ans.path],
                "valid": bool(ans.valid)}

    def _mutate(self, body: dict) -> dict:
        name, srv = self._graph(body)
        if srv.versions is None:
            raise _HttpError(400, f"graph {name!r} is not versioned; "
                                  "register with versioned=True")
        try:
            ops = [MutationOp(str(o["kind"]), int(o["u"]),
                              tuple(int(v) for v in o.get("nbrs", ())),
                              tuple(float(w) for w in o.get("ws", ())))
                   for o in body.get("ops", [])]
        except (KeyError, TypeError, ValueError) as e:
            raise _HttpError(400, f"bad mutation ops: {e}")
        if not ops:
            raise _HttpError(400, 'need non-empty "ops"')
        version = srv.submit_mutation(ops, self._now())
        self._deliver()        # the force-flush completed pending reads
        return {"vid": int(version.vid), "ops": len(ops)}

    def _stats(self) -> dict:
        out = {"uptime_s": self._now(),
               "graphs": self.index_registry.stats()}
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
            out["slo_breaches"] = self.slo.breach_summary()
        return out

    # ------------------------------------------------------------- SSE
    def _metrics_frame(self) -> dict:
        frame = {"ts": round(self._now(), 6), "graphs": {}}
        for gname in self.index_registry.names():
            srv = self.index_registry.get(gname)
            m = srv.metrics
            frame["graphs"][gname] = {
                "served": m.served,
                "cache_hits": m.cache_hits,
                "batches": len(m.batches),
            }
        if self.slo is not None:
            frame["slo"] = self.slo.snapshot()
        return frame

    async def _serve_sse(self, writer):
        """Stream metric frames + SLO alerts until the client leaves.

        Framing (one block per message, blank-line terminated):
        ``event: metrics`` / ``event: slo_alert`` + one ``data:`` JSON
        line; ``: heartbeat`` comment lines keep idle connections alive
        (and are how a consumer distinguishes a quiet healthy server
        from a dead one).
        """
        writer.write((
            "HTTP/1.1 200 OK\r\n"
            f"Content-Type: {_SSE_HDR}\r\n"
            "Cache-Control: no-cache\r\nConnection: keep-alive\r\n\r\n"
        ).encode("latin-1"))
        await writer.drain()
        self._sse_g.inc(1)
        last_seq = -1
        if self.log is not None and self.log.recent:
            last_seq = self.log.recent[-1]["seq"]
        last_frame = None
        last_sent = time.monotonic()
        try:
            while True:
                sent = False
                if self.log is not None:
                    for ev in self.log.recent:
                        if (ev["seq"] > last_seq
                                and ev["kind"] == "slo_alert"):
                            writer.write(_sse_block("slo_alert", ev))
                            sent = True
                    if self.log.recent:
                        last_seq = self.log.recent[-1]["seq"]
                frame = self._metrics_frame()
                comparable = {k: v for k, v in frame.items() if k != "ts"}
                if comparable != last_frame:
                    writer.write(_sse_block("metrics", frame))
                    last_frame = comparable
                    sent = True
                if sent:
                    last_sent = time.monotonic()
                elif time.monotonic() - last_sent >= self.heartbeat_s:
                    writer.write(b": heartbeat\n\n")
                    last_sent = time.monotonic()
                await writer.drain()
                await asyncio.sleep(self.sse_interval_s)
        finally:
            self._sse_g.inc(-1)


def _sse_block(event: str, data: dict) -> bytes:
    return (f"event: {event}\ndata: {json.dumps(data)}\n\n").encode()


# ------------------------------------------------------------------ client
class HttpClient:
    """Minimal blocking client for the front end (stdlib http.client,
    one keep-alive connection). The loadgen replay path: sequential
    requests, so a versioned server observes the identical
    submit/mutate order — and therefore the identical version
    assignment — as the in-process ``serve_readwrite_trace``."""

    def __init__(self, host: str, port: int, graph: str = "default",
                 timeout_s: float = 60.0):
        self.graph = graph
        self._conn = http.client.HTTPConnection(host, port,
                                                timeout=timeout_s)

    def close(self):
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _call(self, method: str, path: str, body=None):
        payload = None if body is None else json.dumps(body).encode()
        headers = {"Content-Type": _JSON_HDR} if payload else {}
        self._conn.request(method, path, body=payload, headers=headers)
        resp = self._conn.getresponse()
        raw = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"{method} {path} -> {resp.status}: "
                               f"{raw[:200].decode(errors='replace')}")
        ctype = resp.getheader("Content-Type", "")
        return raw.decode() if "json" not in ctype else json.loads(raw)

    def query(self, s: int, t: int):
        out = self._call("POST", "/query",
                         {"graph": self.graph, "s": int(s), "t": int(t)})
        return np.float32(out["answers"][0]), out.get("vid")

    def query_batch(self, pairs) -> np.ndarray:
        out = self._call("POST", "/query",
                         {"graph": self.graph,
                          "pairs": [[int(s), int(t)] for s, t in pairs]})
        return np.asarray(out["answers"], np.float32)

    def path(self, s: int, t: int) -> dict:
        return self._call("POST", "/path",
                          {"graph": self.graph, "s": int(s), "t": int(t)})

    def mutate(self, ops) -> int:
        body = {"graph": self.graph,
                "ops": [{"kind": op.kind, "u": int(op.u),
                         "nbrs": [int(v) for v in op.nbrs],
                         "ws": [float(w) for w in op.ws]}
                        for op in ops]}
        return int(self._call("POST", "/mutate", body)["vid"])

    def stats(self) -> dict:
        return self._call("GET", "/stats")

    def metrics_text(self) -> str:
        return self._call("GET", "/metrics")

    def healthz(self) -> dict:
        return self._call("GET", "/healthz")


def replay_http(client: HttpClient, trace, batch: int = 0):
    """Replay a loadgen trace over the wire.

    Read-only traces go as ``/query`` calls (single pair, or ``batch``
    pairs per request when > 0); a ``readwrite`` trace interleaves
    ``/mutate`` for write rows — strictly sequentially, which pins the
    version sequence to the in-process replay's. Returns ``answers``
    (float32, NaN on write rows) or ``(answers, vids)`` when the trace
    carries writes, shaped exactly like ``serve_readwrite_trace`` so
    the caller can diff the two bitwise.
    """
    n_req = len(trace)
    answers = np.full(n_req, np.nan, np.float32)
    if trace.writes is not None:
        vids = np.zeros(n_req, np.int64)
        for i in range(n_req):
            if trace.writes[i] is not None:
                vids[i] = client.mutate(trace.writes[i])
            else:
                answers[i], vid = client.query(int(trace.s[i]),
                                               int(trace.t[i]))
                vids[i] = -1 if vid is None else vid
        return answers, vids
    if batch > 1:
        for lo in range(0, n_req, batch):
            hi = min(lo + batch, n_req)
            answers[lo:hi] = client.query_batch(
                list(zip(trace.s[lo:hi].tolist(),
                         trace.t[lo:hi].tolist())))
    else:
        for i in range(n_req):
            answers[i], _ = client.query(int(trace.s[i]), int(trace.t[i]))
    return answers


class SSEReader:
    """Blocking reader over a ``/events`` stream (tests + CI smoke
    artifact capture): collects parsed ``(event, data_or_None)`` tuples
    — heartbeats appear as ``("comment", None)`` — until closed."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        self._conn = http.client.HTTPConnection(host, port,
                                                timeout=timeout_s)
        self._conn.request("GET", "/events")
        self._resp = self._conn.getresponse()
        if self._resp.status != 200:
            raise RuntimeError(f"/events -> {self._resp.status}")

    def read_events(self, max_events: int = 16,
                    max_s: float = 10.0) -> list:
        out = []
        deadline = time.monotonic() + max_s
        event, data = None, []
        while len(out) < max_events and time.monotonic() < deadline:
            try:
                line = self._resp.fp.readline()
            except (TimeoutError, OSError):
                break
            if not line:
                break
            line = line.decode().rstrip("\n").rstrip("\r")
            if line.startswith(":"):
                out.append(("comment", None))
            elif line.startswith("event:"):
                event = line[6:].strip()
            elif line.startswith("data:"):
                data.append(line[5:].strip())
            elif line == "" and (event or data):
                out.append((event or "message",
                            json.loads("\n".join(data)) if data else None))
                event, data = None, []
        return out

    def close(self):
        self._conn.close()
