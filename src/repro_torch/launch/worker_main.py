#!/usr/bin/env python
"""worker_main: one out-of-process FlowMesh worker lane (DESIGN.md §13).

The port's copy of the reference's ``scripts/worker_main.py``: the same
flags, and the same ``SimExecutor`` lane (the reference's worker runs no
model; ``TorchExecutor`` runs in the service's own process).

Registers with a fabric served with ``--remote-workers``, long-polls
``POST /worker/lease`` for dispatched batches, executes them with the local
executor while a background thread heartbeats the lease, and reports the
result to ``POST /worker/complete``. A fenced or revoked lease means the
control plane moved on — the result is dropped and the lane keeps serving.
A *transient* heartbeat failure (503 blip, 409 mid-failover) is NOT a lost
lease: the server-side lease stays live for a full TTL after the last
successful renewal, so the loop keeps retrying inside that budget before
giving the batch up.

``--url`` accepts a comma-separated endpoint list (primary + standbys):
the worker then talks through ``ClusterAPI`` and rides an auto-promotion
without restarting — its writes re-resolve to whichever process owns the
journal epoch.

    PYTHONPATH=src python -m repro_torch.launch.worker_main \\
        --url http://127.0.0.1:8123,http://127.0.0.1:8124 \\
        --worker-id w1 --device-class h100-nvl-94g
"""
from __future__ import annotations

import argparse
import os
import sys
import threading
import time

from repro_torch.core.cost_model import DEVICE_CLASSES
from repro_torch.core.simulator import SimExecutor
from repro_torch.core.transport import batch_from_wire, result_to_wire
from repro_torch.core.worker import Worker, WorkerState
from repro_torch.fabric.cluster import ClusterAPI
from repro_torch.fabric.http import RemoteAPI


class WorkerProcess:
    def __init__(self, url: str, worker_id: str, device_class: str, *,
                 seed: int = 0, poll_s: float = 10.0,
                 slow_ms: float = 0.0, api=None) -> None:
        if api is not None:
            self.api = api              # injected (tests)
        elif "," in url:
            # endpoint list: ride failovers through the cluster client
            self.api = ClusterAPI(url, timeout_s=poll_s + 30.0)
        else:
            self.api = RemoteAPI(url, timeout_s=poll_s + 30.0)
        self.requested_id = worker_id
        self.worker_id = worker_id
        self.device_class = device_class
        self.poll_s = poll_s
        self.slow_ms = slow_ms
        self.heartbeat_s = 1.0          # replaced by the register response
        self.lease_ttl_s = 4.0          # replaced by the register response
        self.executor = SimExecutor(seed=seed)
        #: local lane shell: a persistent ResidentSet across batches keeps
        #: hot/cold behavior on this lane realistic
        self.shell = Worker(worker_id, DEVICE_CLASSES[device_class], now=0.0)
        self.shell.state = WorkerState.ACTIVE
        self.done = 0

    # ---------------------------------------------------------------- wire --
    def register(self) -> int:
        code, out = self.api.handle("POST", "/worker/register", {
            "worker_id": self.requested_id,
            "device_class": self.device_class})
        if code != 200:
            print(f"register: HTTP {code} {out}", file=sys.stderr, flush=True)
            return code
        # adopt the assigned id — a crashed predecessor keeps our name
        self.worker_id = out["worker_id"]
        self.shell.worker_id = self.worker_id
        self.heartbeat_s = float(out.get("heartbeat_s") or 1.0)
        self.lease_ttl_s = float(out.get("lease_ttl_s")
                                 or 4.0 * self.heartbeat_s)
        print(f"registered as {self.worker_id} "
              f"(heartbeat {self.heartbeat_s:.2f}s)", flush=True)
        return code

    def _register_until_ok(self) -> bool:
        backoff = 0.2
        while True:
            code = self.register()
            if code == 200:
                return True
            if code in (409,):   # fenced primary / no remote transport
                return False
            time.sleep(backoff)
            backoff = min(backoff * 2, 5.0)

    def _heartbeat_loop(self, lease_id: str, stop: threading.Event,
                        lost: threading.Event) -> None:
        """Renew the lease until the batch finishes or it is truly gone.

        Only two answers mean the lease is lost: HTTP 410 (fenced — the
        control plane re-granted or expired it) and an explicit
        ``revoked`` (cancellation: abandoning the batch is the ack).
        Everything else — 503 unreachable blip, 5xx, a 409 from a fenced
        primary mid-failover — is transient: the *server-side* lease
        stays live for a full TTL after our last successful renewal, so
        we keep retrying inside that budget instead of discarding a
        fully computed batch on the first hiccup."""
        grace_deadline: float | None = None
        while not stop.wait(self.heartbeat_s):
            code, out = self.api.handle("POST", "/worker/heartbeat", {
                "worker_id": self.worker_id, "lease_id": lease_id})
            ok = code == 200 and isinstance(out, dict) and out.get("ok")
            if ok:
                grace_deadline = None
                continue
            revoked = (code == 200 and isinstance(out, dict)
                       and out.get("revoked"))
            if code == 410 or revoked:
                lost.set()       # revoked or fenced: abandon the batch
                return
            now = time.monotonic()
            if grace_deadline is None:
                grace_deadline = now + self.lease_ttl_s
            if now >= grace_deadline:
                print(f"lease {lease_id}: no successful heartbeat for "
                      f"{self.lease_ttl_s:.1f}s; assuming expired",
                      file=sys.stderr, flush=True)
                lost.set()
                return

    # ------------------------------------------------------------- execute --
    def run_one(self, lease: dict) -> None:
        lease_id = lease["lease_id"]
        batch = batch_from_wire(lease["batch"])
        stop, lost = threading.Event(), threading.Event()
        hb = threading.Thread(target=self._heartbeat_loop,
                              args=(lease_id, stop, lost), daemon=True)
        hb.start()
        try:
            if self.slow_ms > 0:
                # test/CI hook: hold the batch so a harness can kill -9
                # this process while the lease is live (heartbeats keep
                # renewing it until the kill lands)
                time.sleep(self.slow_ms / 1000.0)
            result = self.executor.execute(batch, self.shell, None)
            spec = batch.groups[0].spec
            if spec.model_id and not result.failed:
                self.shell.make_resident(spec.h_model, spec.model_id)
        finally:
            stop.set()
        hb.join()
        if lost.is_set():
            print(f"lease {lease_id} revoked/fenced; result dropped",
                  flush=True)
            return
        # the completion gets the same transient-vs-terminal treatment as
        # heartbeats: an unreachable/fenced primary mid-failover is retried
        # within the TTL budget (ClusterAPI re-resolves underneath us)
        deadline = time.monotonic() + self.lease_ttl_s
        while True:
            code, out = self.api.handle("POST", "/worker/complete", {
                "worker_id": self.worker_id, "lease_id": lease_id,
                "result": result_to_wire(result)})
            if code == 200 and isinstance(out, dict) and out.get("ok"):
                self.done += 1
                return
            if code in (503, 409) and time.monotonic() < deadline:
                time.sleep(min(self.heartbeat_s, 0.5))
                continue
            # 410 = fenced (lease lapsed under us), revoked, or the engine
            # re-dispatched: either way the work is not ours anymore
            print(f"complete {lease_id}: HTTP {code} {out}", flush=True)
            return

    # ---------------------------------------------------------------- loop --
    def loop(self, max_batches: int | None = None) -> int:
        if not self._register_until_ok():
            return 1
        while max_batches is None or self.done < max_batches:
            code, out = self.api.handle("POST", "/worker/lease", {
                "worker_id": self.worker_id, "wait_s": self.poll_s})
            if code == 200:
                lease = out.get("lease") if isinstance(out, dict) else None
                if lease is not None:
                    self.run_one(lease)
                continue
            if code == 410:
                # lane expired server-side: start over (possibly new id)
                if not self._register_until_ok():
                    return 1
                continue
            if code == 409:
                print(f"fabric refused lane: {out}", file=sys.stderr,
                      flush=True)
                return 1
            time.sleep(0.5)      # unreachable/5xx: retry quietly
        print(f"{self.worker_id}: {self.done} batches served", flush=True)
        return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="worker_main", description=__doc__)
    ap.add_argument("--url", required=True,
                    help="fabric base URL (serve --remote-workers); a "
                         "comma-separated list enables the cluster client "
                         "(failover-riding)")
    ap.add_argument("--worker-id", default=None,
                    help="requested lane id (default: worker-<pid>); the "
                         "fabric may assign a suffixed one")
    ap.add_argument("--device-class", default="h100-nvl-94g",
                    choices=sorted(DEVICE_CLASSES),
                    help="device class this lane advertises")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--poll-s", type=float, default=10.0,
                    help="long-poll hold per lease request")
    ap.add_argument("--slow-ms", type=float, default=0.0,
                    help="sleep this long before executing each batch "
                         "(kill -9 harness hook; heartbeats continue)")
    ap.add_argument("--max-batches", type=int, default=None,
                    help="exit after serving N batches")
    args = ap.parse_args(argv)
    wid = args.worker_id or f"worker-{os.getpid()}"
    wp = WorkerProcess(args.url, wid, args.device_class, seed=args.seed,
                       poll_s=args.poll_s, slow_ms=args.slow_ms)
    try:
        return wp.loop(args.max_batches)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
