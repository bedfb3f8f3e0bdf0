"""Thin HTTP client for the tuning daemon (urllib only).

:class:`TuningClient` speaks :mod:`repro_torch.service.wire`'s JSON surface;
:class:`RemoteSession` mirrors the session verbs so remote code reads
like local ask/tell::

    client = TuningClient("http://127.0.0.1:8421")
    sess = client.create_session("yi-6b:train_4k", budget=16, seed=3)
    for _ in range(4):
        configs = sess.ask()
        sess.tell(configs, [my_benchmark(c) for c in configs])
    best_cfg, best_val = sess.best()

or hands the whole drive to the server (the shared-pool path that
cache-shares probes with every other user of the workload)::

    result = sess.run()          # blocks; returns best + full trace

Errors come back as :class:`TuningServiceError` carrying the HTTP
status and the server's message.

A BO ``cfg`` is sent with the reference package's field names
(``use_kernel`` goes out as ``use_pallas``), so this client drives the
reference's daemon as well as this package's; ``cfg.device`` is refused
here, as the daemon would refuse it.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.space import Space
from repro_torch.service.server import cfg_to_wire
from repro_torch.service.wire import space_from_json


class TuningServiceError(RuntimeError):
    """``status`` is the HTTP status the server replied with, or 0 for a
    transport-level failure (connection refused/reset, timeout) where no
    server reply exists — for a non-idempotent verb that means the server
    *may or may not* have applied the request."""

    def __init__(self, status: int, message: str):
        super().__init__(f"[{status}] {message}")
        self.status = status
        self.message = message


# verbs safe to resend on a transport failure: every GET (pure reads)
# plus POST ask — a lost ask response leaves at most an untold batch
# behind, which the strategy's budget accounting already tolerates.
# tell / create-session / run / close are NOT safe: resending a tell the
# server already applied double-counts observations, and a second
# create-session opens a second session.
def _idempotent(method: str, path: str) -> bool:
    return method == "GET" or path.endswith("/ask")


class TuningClient:
    """``retries``/``retry_backoff_s`` bound the transport-retry loop on
    idempotent verbs (see :func:`_idempotent`): ``retries`` is the number
    of *re*-sends after the first attempt, each preceded by an
    exponentially growing ``retry_backoff_s * 2**i`` sleep.  Server-side
    errors (any HTTP reply, 4xx/5xx) are never retried — the server
    spoke; transport failures on non-idempotent verbs raise immediately
    with status 0 and a message saying the outcome is unknown."""

    def __init__(self, base_url: str, timeout: float = 600.0,
                 retries: int = 3, retry_backoff_s: float = 0.2):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s

    def _call(self, method: str, path: str,
              payload: Optional[dict] = None) -> dict:
        data = None
        headers = {"Accept": "application/json"}
        if method == "POST":
            data = json.dumps(payload or {}).encode()
            headers["Content-Type"] = "application/json"
        attempts = 1 + (self.retries if _idempotent(method, path) else 0)
        for attempt in range(attempts):
            req = urllib.request.Request(self.base_url + path, data=data,
                                         headers=headers, method=method)
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as resp:
                    return json.loads(resp.read() or b"{}")
            except urllib.error.HTTPError as e:
                # the server replied: this is a service error, never a
                # transport flake — no retry regardless of verb.  (Must
                # precede URLError: HTTPError subclasses it.)
                try:
                    msg = json.loads(e.read() or b"{}").get("error", str(e))
                except json.JSONDecodeError:
                    msg = str(e)
                raise TuningServiceError(e.code, msg) from None
            except (urllib.error.URLError, ConnectionError,
                    TimeoutError) as e:
                reason = getattr(e, "reason", None) or e
                if attempt + 1 < attempts:
                    time.sleep(self.retry_backoff_s * 2.0 ** attempt)
                    continue
                if not _idempotent(method, path):
                    raise TuningServiceError(
                        0, f"transport failure on non-idempotent "
                        f"{method} {path} ({reason!r}): the server may or "
                        "may not have applied this request — inspect "
                        "session state before resending") from e
                raise TuningServiceError(
                    0, f"transport failure on {method} {path} after "
                    f"{attempts} attempts ({reason!r})") from e

    # -- daemon-level --------------------------------------------------------

    def health(self) -> dict:
        return self._call("GET", "/v1/health")

    def workloads(self) -> List[dict]:
        return self._call("GET", "/v1/workloads")["workloads"]

    def stats(self) -> dict:
        return self._call("GET", "/v1/stats")

    def sessions(self) -> List[dict]:
        return self._call("GET", "/v1/sessions")["sessions"]

    def create_session(self, workload: str, **kwargs) -> "RemoteSession":
        """Create a session; kwargs pass straight to the wire's
        create-session fields.  Two that matter for warm starts:
        ``transfer_from`` (``True`` or a spec dict) makes a
        ``strategy="transfer_bo"`` session mine the daemon's sharded log
        for sibling-workload evidence, and ``resume="s0007"`` reopens an
        idle-evicted session from its server-side snapshot.  A
        ``strategy_kwargs`` cfg dict goes out in the reference's field
        names (:func:`~repro_torch.service.server.cfg_to_wire`)."""
        sk = kwargs.get("strategy_kwargs")
        cfg = sk.get("cfg") if isinstance(sk, dict) else None
        if isinstance(cfg, dict):
            if "device" in cfg:
                raise ValueError("cfg.device is not a session field: the "
                                 "daemon fits every session on its own "
                                 "--device")
            kwargs = {**kwargs, "strategy_kwargs": {**sk,
                                                    "cfg": cfg_to_wire(cfg)}}
        out = self._call("POST", "/v1/sessions",
                         {"workload": workload, **kwargs})
        return RemoteSession(self, out["session"], out["workload"],
                             space_from_json(out["space"]))


class RemoteSession:
    """Client-side handle; the strategy state lives on the server."""

    def __init__(self, client: TuningClient, session_id: str,
                 workload: str, space: Space):
        self.client = client
        self.session_id = session_id
        self.workload = workload
        self.space = space          # decoded: validate configs locally

    def _call(self, method: str, verb: str,
              payload: Optional[dict] = None) -> dict:
        return self.client._call(
            method, f"/v1/sessions/{self.session_id}/{verb}", payload)

    def ask(self, n: Optional[int] = None) -> List[Dict]:
        payload = {} if n is None else {"n": n}
        return self._call("POST", "ask", payload)["configs"]

    def tell(self, configs: Sequence[Dict], values: Sequence[float],
             variances: Optional[Sequence[float]] = None) -> int:
        payload = {"configs": list(configs),
                   "values": [float(v) for v in values]}
        if variances is not None:
            payload["variances"] = [float(v) for v in variances]
        return self._call("POST", "tell", payload)["told"]

    def run(self, budget: Optional[int] = None,
            batch_size: Optional[int] = None,
            fidelity: Optional[str] = None) -> dict:
        payload = {k: v for k, v in (("budget", budget),
                                     ("batch_size", batch_size),
                                     ("fidelity", fidelity))
                   if v is not None}
        return self._call("POST", "run", payload)

    def best(self) -> Tuple[Dict, float]:
        out = self._call("GET", "best")
        return out["config"], out["value"]

    def history(self, limit: Optional[int] = None) -> List[dict]:
        verb = "history" if limit is None else f"history?limit={limit}"
        return self._call("GET", verb)["records"]

    def state(self) -> dict:
        return self._call("GET", "state")["state"]

    def close(self) -> None:
        self._call("POST", "close")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            self.close()
        except TuningServiceError:
            pass                    # already closed server-side
