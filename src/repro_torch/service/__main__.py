"""``python -m repro_torch.service`` — run the tuning daemon.

Example::

    python -m repro_torch.service --port 8421 --db-root /tmp/tuning \\
        --workers 8 --shards 4 --device cuda

Then, from any client::

    curl -s localhost:8421/v1/workloads
    curl -s -X POST localhost:8421/v1/sessions \\
        -d '{"workload": "yi-6b:train_4k", "budget": 16, "seed": 3}'

Every session's GP is fitted and queried on ``--device``: ``cuda`` (the
default) or ``cpu``.  Either package's client can drive it.
"""

from __future__ import annotations

import argparse

from repro_torch.service.server import TuningServer, default_catalog
from repro_torch.service.wire import make_wire_server


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="Sapphire tuning daemon: sessions over a shared "
                    "evaluation pool")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8421)
    p.add_argument("--db-root", default=None,
                   help="directory for the sharded evaluation log "
                        "(default: in-memory)")
    p.add_argument("--workers", type=int, default=4,
                   help="evaluation worker threads in the shared pool")
    p.add_argument("--shards", type=int, default=4,
                   help="JSONL shards in the evaluation log")
    p.add_argument("--cache", type=int, default=4096,
                   help="probe-cache capacity (completed results)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where every session's GP runs (default: cuda; "
                        "raises when CUDA is absent)")
    p.add_argument("--workloads", nargs="*", default=None,
                   help="restrict the hosted catalog to these names")
    args = p.parse_args(argv)

    catalog = default_catalog()
    if args.workloads:
        missing = [w for w in args.workloads if w not in catalog]
        if missing:
            p.error(f"unknown workloads {missing}; "
                    f"catalog: {sorted(catalog)}")
        catalog = {w: catalog[w] for w in args.workloads}

    tuning = TuningServer(catalog, db_root=args.db_root,
                          n_shards=args.shards, max_workers=args.workers,
                          cache_capacity=args.cache, device=args.device)
    httpd = make_wire_server(tuning, args.host, args.port)
    host, port = httpd.server_address[:2]
    print(f"tuning daemon on http://{host}:{port} "
          f"({len(catalog)} workloads, {args.workers} workers, "
          f"device {tuning.device}, "
          f"db={'memory' if not args.db_root else args.db_root})")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        httpd.shutdown()
        tuning.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
