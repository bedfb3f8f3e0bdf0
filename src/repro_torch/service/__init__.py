"""Tuning-as-a-service: the Sapphire workflow as a persistent daemon.

Layer map (each module's docstring has the details):

* :mod:`~repro_torch.service.cache`    — cross-session probe cache
* :mod:`~repro_torch.service.pool`     — shared worker pool + session views
* :mod:`~repro_torch.service.shardlog` — sharded EvalDB + session namespaces
* :mod:`~repro_torch.service.session`  — one Controller+strategy conversation
* :mod:`~repro_torch.service.server`   — the daemon (workloads, sessions)
* :mod:`~repro_torch.service.wire`     — HTTP/JSON surface (http.server)
* :mod:`~repro_torch.service.client`   — thin urllib client

``python -m repro_torch.service [--device cuda|cpu]`` runs the daemon;
every session's GP runs on its device.
"""

from repro_torch.service.cache import ProbeCache, probe_key
from repro_torch.service.client import RemoteSession, TuningClient, \
    TuningServiceError
from repro_torch.service.pool import (PoolView, SharedEvaluationPool,
                                      WorkloadPool)
from repro_torch.service.server import (TuningServer, WorkloadSpec,
                                        default_catalog)
from repro_torch.service.session import SessionClosed, TuningSession
from repro_torch.service.shardlog import SessionDB, ShardedEvalLog
from repro_torch.service.wire import (make_wire_server, serve_background,
                                      space_from_json, space_to_json)
