"""Process entry point: `python -m karpenter_tpu_torch`.

The port of the JAX package's `__main__.py`, the analog of
karpenter:cmd/controller/main.go:32-73 — parse options, build the operator,
assemble core + provider controllers, serve endpoints, run the manager until
interrupted.  Runs against the in-memory substrate, its solves on the card.
Logging is configured from the options by `utils.tracing.configure_logging`
(`--log-format text|json`, `--trace-slow-ms`).  `--leader-elect` (or `--ha-failover`) elects through a lease
file shared by the replicas on this host; `--warm-restart` with
`--snapshot-path` restores on startup and snapshots on a cadence and on
SIGTERM.

`main(argv, device="cuda")`: the `device` keyword is how a test runs the
entry point on the CPU; the command line has no such flag.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import threading

from .operator import ControllerManager, Operator, Options, build_controllers
from .utils.tracing import configure_logging


def _build_leader(options):
    """Leadership elector for --leader-elect: a TTL'd lease file shared by
    the replicas on this host (the charts' 2-replica HA analog).  The lease
    carries the fencing epoch the HAFailover gate validates on every
    snapshot and cloud write."""
    if not options.leader_elect:
        return None
    import socket
    import tempfile
    from .operator.manager import LeaderElector
    lease = options.lease_path or os.path.join(
        tempfile.gettempdir(), f"karpenter-{options.cluster_name}.lease")
    identity = f"{socket.gethostname()}-{os.getpid()}"
    return LeaderElector(lease, identity, ttl=options.lease_ttl_s)


def _stop_on_signal(manager):
    """The SIGTERM / SIGINT handler.  It runs on the main thread, where a
    tick may hold the state lock (a plain lock) that `stop()` takes, so it
    only ends `run()` after that tick, from a thread of its own; `main`
    then drains with `stop()`."""
    def handler(*_):
        threading.Thread(target=manager.request_stop, name="stop-signal",
                         daemon=True).start()
    return handler


def main(argv=None, device="cuda") -> int:
    # options first: the log handler (text vs json, slow-span threshold)
    # is itself configured by flags/env
    options = Options.from_args(argv)
    configure_logging(options)
    op = Operator(options, device=device)
    manager = ControllerManager(op, build_controllers(op),
                                leader=_build_leader(options))
    # readiness ladder BEFORE serving: warm restore (hydration already
    # rebuilt what it could from cloud tags; a valid snapshot supersedes
    # it, any mismatch falls back cold), then the arena parity probe, then
    # the role phase — /readyz stays 503 until the ladder completes
    outcome = manager.startup()
    if options.gate("WarmRestart") and options.snapshot_path:
        logging.info("warm restart: %s", outcome)
    port = manager.serve_endpoints()
    logging.info("karpenter-tpu up: cluster=%s endpoints=127.0.0.1:%s "
                 "controllers=%s", options.cluster_name, port,
                 sorted(manager.controllers))
    signal.signal(signal.SIGTERM, _stop_on_signal(manager))
    signal.signal(signal.SIGINT, _stop_on_signal(manager))
    try:
        manager.run()
    finally:
        manager.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
