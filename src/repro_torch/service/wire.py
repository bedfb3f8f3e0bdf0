"""HTTP/JSON surface for the tuning daemon (stdlib only).

One :class:`~http.server.ThreadingHTTPServer` fronts a
:class:`~repro_torch.service.server.TuningServer`; every endpoint maps 1:1
onto a server/session method, with the blocking ``run`` endpoint held
open for the whole server-side drive (each request runs on its own
thread, so a long ``run`` never starves ``ask``/``tell`` traffic on
other sessions).

::

    GET  /v1/health                       liveness + version
    GET  /v1/workloads                    hosted workload catalog
    GET  /v1/stats                        daemon counters + cache stats
    GET  /v1/sessions                     open sessions
    POST /v1/sessions                     create-session
         (``transfer_from`` warm-starts a ``transfer_bo`` session from
         the daemon's own sharded log; ``resume`` reopens an evicted
         session from its snapshot by id)
    POST /v1/sessions/<id>/ask            {"n": int?}        -> configs
    POST /v1/sessions/<id>/tell           {configs, values, variances?}
    POST /v1/sessions/<id>/run            {budget?, batch_size?, fidelity?}
    GET  /v1/sessions/<id>/best           incumbent config + value
    GET  /v1/sessions/<id>/history?limit= namespaced EvalDB records
    GET  /v1/sessions/<id>/state          strategy state_dict (warm restart)
    POST /v1/sessions/<id>/close          close-session

Errors are JSON too: ``{"error": msg}`` with 400 (bad request), 404
(unknown session/workload/route) or 409 (closed session / no
observations yet).  The Space codec round-trips every knob field and
all four constraint classes so a remote client can validate configs
locally before ``tell``-ing them.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple

from repro_torch.core.space import (Divides, Knob, Leq, ProductLeq, Space,
                                    SumLeq)
from repro_torch.core.strategy import _json_cfg
from repro_torch.service.server import TuningServer
from repro_torch.service.session import SessionClosed

WIRE_VERSION = 1


# ---------------------------------------------------------------------------
# Space <-> JSON
# ---------------------------------------------------------------------------

_CONSTRAINTS = {"sum_leq": SumLeq, "leq": Leq, "divides": Divides,
                "product_leq": ProductLeq}


def constraint_to_json(c) -> dict:
    for name, cls in _CONSTRAINTS.items():
        if type(c) is cls:
            d = {"type": name, "knobs": list(c.knobs)}
            if name in ("sum_leq", "product_leq"):
                d["limit"] = c.limit
            if name == "divides":
                d["target"] = c.target
            return d
    raise TypeError(f"cannot serialize constraint {type(c).__name__}")


def constraint_from_json(d: dict):
    cls = _CONSTRAINTS[d["type"]]
    knobs = tuple(d["knobs"])
    if d["type"] in ("sum_leq", "product_leq"):
        return cls(knobs, limit=float(d["limit"]))
    if d["type"] == "divides":
        t = d.get("target")
        return cls(knobs, target=None if t is None else int(t))
    return cls(knobs)


def knob_to_json(k: Knob) -> dict:
    return {"name": k.name, "kind": k.kind, "default": k.default,
            "lo": k.lo, "hi": k.hi,
            "choices": list(k.choices) if k.choices is not None else None,
            "log_scale": k.log_scale, "dynamic_bound": k.dynamic_bound,
            "align": k.align, "configurable": k.configurable,
            "gated_by": ([k.gated_by[0], list(k.gated_by[1])]
                         if k.gated_by is not None else None),
            "module": k.module, "restart_required": k.restart_required,
            "inert": k.inert, "description": k.description}


def knob_from_json(d: dict) -> Knob:
    gated = d.get("gated_by")
    choices = d.get("choices")
    return Knob(d["name"], d["kind"], d["default"],
                lo=d.get("lo"), hi=d.get("hi"),
                choices=tuple(choices) if choices is not None else None,
                log_scale=bool(d.get("log_scale", False)),
                dynamic_bound=bool(d.get("dynamic_bound", False)),
                align=int(d.get("align", 1)),
                configurable=bool(d.get("configurable", True)),
                gated_by=((gated[0], tuple(gated[1]))
                          if gated is not None else None),
                module=str(d.get("module", "core")),
                restart_required=bool(d.get("restart_required", True)),
                inert=bool(d.get("inert", False)),
                description=str(d.get("description", "")))


def space_to_json(space: Space) -> dict:
    return {"knobs": [knob_to_json(k) for k in space.knobs],
            "constraints": [constraint_to_json(c)
                            for c in space.constraints]}


def space_from_json(d: dict) -> Space:
    return Space(tuple(knob_from_json(k) for k in d["knobs"]),
                 tuple(constraint_from_json(c)
                       for c in d.get("constraints", ())))


def record_to_json(r) -> dict:
    return {"config": _json_cfg(r.config), "value": r.value,
            "wall_s": r.wall_s, "tag": r.tag, "workload": r.workload,
            "fidelity": r.fidelity, "status": r.status,
            "repeats": r.repeats, "variance": r.variance}


def trace_to_json(t) -> dict:
    return {"configs": [_json_cfg(c) for c in t.configs],
            "values": [float(v) for v in t.values],
            "variances": [float(v) for v in t.variances],
            "best_values": [float(v) for v in t.best_values],
            "boundary_events": [[int(i), str(k)]
                                for i, k in t.boundary_events]}


# ---------------------------------------------------------------------------
# the request handler
# ---------------------------------------------------------------------------

class _ApiError(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


_SESSION_PATH = re.compile(
    r"^/v1/sessions/([^/]+)/(ask|tell|run|best|history|state|close)$")


class TuningRequestHandler(BaseHTTPRequestHandler):
    """Routes one request; ``self.server.tuning`` is the TuningServer."""

    protocol_version = "HTTP/1.1"

    # -- plumbing -----------------------------------------------------------

    def log_message(self, fmt, *args):    # quiet by default; the daemon
        pass                              # entrypoint has its own logging

    def _payload(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        if n == 0:
            return {}
        try:
            body = json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError as e:
            raise _ApiError(400, f"bad JSON body: {e}")
        if not isinstance(body, dict):
            raise _ApiError(400, "JSON body must be an object")
        return body

    def _reply(self, obj, code: int = 200):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _session(self, sid: str):
        try:
            return self.server.tuning.session(sid)
        except KeyError as e:
            raise _ApiError(404, str(e))

    def _dispatch(self, method: str):
        srv: TuningServer = self.server.tuning
        path, _, query = self.path.partition("?")
        try:
            if path == "/v1/health" and method == "GET":
                return self._reply({"ok": True, "version": WIRE_VERSION})
            if path == "/v1/workloads" and method == "GET":
                return self._reply({"workloads": srv.workloads()})
            if path == "/v1/stats" and method == "GET":
                return self._reply(srv.stats())
            if path == "/v1/sessions" and method == "GET":
                return self._reply({"sessions": srv.list_sessions()})
            if path == "/v1/sessions" and method == "POST":
                return self._create(srv)
            m = _SESSION_PATH.match(path)
            if m is not None:
                return self._session_call(m.group(1), m.group(2),
                                          method, query)
            raise _ApiError(404, f"no route {method} {path}")
        except _ApiError as e:
            self._reply({"error": str(e)}, e.code)
        except SessionClosed as e:
            self._reply({"error": str(e)}, 409)
        except (KeyError, TypeError, ValueError) as e:
            self._reply({"error": str(e)}, 400)
        except Exception as e:           # never a half-closed socket
            self._reply({"error": f"internal: {e!r}"}, 500)

    # -- endpoints ----------------------------------------------------------

    def _create(self, srv: TuningServer):
        body = self._payload()
        try:
            workload = body.pop("workload")
        except KeyError:
            raise _ApiError(400, "create-session needs a 'workload'")
        allowed = {"strategy", "budget", "seed", "batch_size",
                   "strategy_kwargs", "replication", "deterministic",
                   "tag", "state", "transfer_from", "resume"}
        unknown = set(body) - allowed
        if unknown:
            raise _ApiError(400, f"unknown create-session fields "
                                 f"{sorted(unknown)}")
        try:
            sess = srv.create_session(workload, **body)
        except KeyError as e:
            raise _ApiError(404, str(e))
        self._reply({"session": sess.session_id,
                     "workload": sess.workload,
                     "strategy": sess.strategy_name,
                     "space": space_to_json(sess.strategy.space)},
                    201)

    def _session_call(self, sid: str, verb: str, method: str, query: str):
        wants_post = verb in ("ask", "tell", "run", "close")
        if (method == "POST") != wants_post:
            raise _ApiError(405,
                            f"{verb} is {'POST' if wants_post else 'GET'}")
        srv: TuningServer = self.server.tuning
        sess = self._session(sid)
        if verb == "ask":
            n = self._payload().get("n")
            cfgs = sess.ask(None if n is None else int(n))
            return self._reply({"configs": cfgs})
        if verb == "tell":
            body = self._payload()
            told = sess.tell(body.get("configs", []),
                             body.get("values", []),
                             body.get("variances"))
            return self._reply({"told": told})
        if verb == "run":
            body = self._payload()
            trace = sess.run(budget=body.get("budget"),
                             batch_size=body.get("batch_size"),
                             fidelity=body.get("fidelity"))
            cfg, val = trace.best
            return self._reply({"best_config": _json_cfg(cfg),
                                "best_value": float(val),
                                "n_evaluations": len(trace.values),
                                "trace": trace_to_json(trace)})
        if verb == "best":
            try:
                cfg, val = sess.best()
            except SessionClosed:
                raise
            except (ValueError, RuntimeError):
                raise _ApiError(409, f"session {sid} has no "
                                     "observations yet")
            return self._reply({"config": cfg, "value": val})
        if verb == "history":
            limit = None
            m = re.search(r"(?:^|&)limit=(\d+)", query)
            if m:
                limit = int(m.group(1))
            return self._reply({"records": [record_to_json(r)
                                            for r in sess.history(limit)]})
        if verb == "state":
            return self._reply({"state": sess.state()})
        if verb == "close":
            srv.close_session(sid)
            return self._reply({"closed": sid})
        raise _ApiError(404, f"no verb {verb!r}")    # pragma: no cover

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")


# ---------------------------------------------------------------------------
# server bootstrap
# ---------------------------------------------------------------------------

def make_wire_server(tuning: TuningServer, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Bind the HTTP front end (``port=0`` picks an ephemeral port —
    ``httpd.server_address`` has the real one).  The caller owns both
    lifecycles: ``httpd.shutdown()`` stops serving, ``tuning.close()``
    stops the daemon."""
    httpd = ThreadingHTTPServer((host, port), TuningRequestHandler)
    httpd.daemon_threads = True
    httpd.tuning = tuning
    return httpd


def serve_background(tuning: TuningServer, host: str = "127.0.0.1",
                     port: int = 0) -> Tuple[ThreadingHTTPServer,
                                             threading.Thread]:
    """In-process daemon for tests/examples: serve on a background
    thread, return (httpd, thread)."""
    httpd = make_wire_server(tuning, host, port)
    thread = threading.Thread(target=httpd.serve_forever,
                              name="tuning-wire", daemon=True)
    thread.start()
    return httpd, thread
