"""Elastic master: dataset task dispatch with lease/timeout/retry/snapshot.

Capability parity with the Go master (go/master/service.go): SetDataset
partitions recordio shards into tasks (:280, partition :106), GetTask
leases with a timeout (:368), TaskFinished (:411) / TaskFailed (:455),
a timeout watchdog (checkTimeoutFunc :341), failureMax retirement
(processFailedTask :313), state snapshot/recover (:207/:166), and the
save-model election (RequestSaveModel :481). The lease state machine is
the native C++ task queue; this module adds the RPC transport (line-JSON
over TCP — the net/rpc equivalent) and file-based snapshot persistence
(the etcd equivalent on a shared filesystem).

The JAX package's ``distributed/master.py`` on the port, over the port's
own ``native.TaskQueue`` (the same C++ state machine, so the snapshot
files are the same bytes) and RPC channel: the same methods and fields,
so a port client talks to a JAX package master and the other way round.
"""

import base64
import json
import os
import socketserver
import threading
import time
import warnings

from paddle_tpu_torch import fault
from paddle_tpu_torch import native
from paddle_tpu_torch.distributed import rpc

__all__ = ["MasterServer", "MasterClient"]

# legacy aliases (pserver/membership historically imported these from
# here); the typed-error framing now lives in distributed/rpc.py
_send_msg = rpc.send_msg
_recv_msg = rpc.recv_msg


class MasterServer(rpc.FederationRpcMixin):
    """``MasterServer(("127.0.0.1", 0)).start()`` — returns once listening;
    ``.address`` is the bound endpoint. Thread-based; one request per
    connection round, persistent connections supported."""

    fleet_role = "master"

    def __init__(self, address=("127.0.0.1", 0), failure_max=3,
                 snapshot_path=None, lease_timeout=60.0,
                 watchdog_interval=1.0):
        self._queue = native.TaskQueue(failure_max=failure_max)
        self._snapshot_path = snapshot_path
        self._default_lease = lease_timeout
        self._watchdog_interval = watchdog_interval
        self._lock = threading.Lock()
        self._persist_lock = threading.Lock()
        self._save_grant = (None, 0.0)  # (trainer_id, expiry)
        self._dataset_set = False
        self._dirty = False
        self._stop = threading.Event()
        self._inflight = 0
        self._inflight_cv = threading.Condition()

        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                rpc.serve_stream(outer, "master", self.rfile,
                                 self.connection, outer._stop)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(address, Handler)
        self.address = self._server.server_address

    def _handle_request(self, req):
        """serve_stream hook: count the dispatch as in-flight BEFORE the
        _stop check — shutdown() waits for in-flight to drain to zero, so
        a handler that passes the check can never apply+ack a mutation
        after the final snapshot."""
        with self._inflight_cv:
            self._inflight += 1
        try:
            if self._stop.is_set():
                # never ack a mutation the snapshot won't see
                return {"ok": False, "error": "master shutting down"}
            return rpc.dispatch(self, "master", req)
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    # ---- lifecycle ----

    def start(self):
        if self._snapshot_path and (
                os.path.exists(self._snapshot_path)
                or os.path.exists(self._snapshot_path + ".bak")):
            self.recover()
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        self._watchdog = threading.Thread(target=self._watch, daemon=True)
        self._watchdog.start()
        return self

    def shutdown(self, drain_timeout=5.0):
        self._stop.set()
        self._server.shutdown()
        self._server.server_close()
        # flush AFTER the server stops accepting work: an RPC acknowledged
        # during shutdown must still reach the snapshot. Handlers refuse
        # mutations once _stop is set; wait for any dispatch that passed
        # the check before the flag flipped to finish, then persist.
        deadline = time.time() + drain_timeout
        with self._inflight_cv:
            while self._inflight > 0 and time.time() < deadline:
                self._inflight_cv.wait(max(deadline - time.time(), 0.01))
        self._persist()
        # a handler that outlived the drain window can still apply+ack a
        # mutation after that persist (the watchdog is stopped by now) —
        # catch stragglers with a second bounded drain + re-flush
        with self._inflight_cv:
            while (self._inflight > 0
                   and time.time() < deadline + drain_timeout):
                self._inflight_cv.wait(0.1)
        if self._dirty:
            # the watchdog is stopped: there is no "next tick" to retry a
            # failed write, so the final flush must surface the error to
            # the shutdown caller instead of silently dropping acked state
            self._persist(raise_on_error=True)

    def _watch(self):
        while not self._stop.wait(self._watchdog_interval):
            if self._queue.check_timeouts() or self._dirty:
                self._persist()

    def _mark_dirty(self):
        """Debounced persistence: per-task RPCs mark the queue dirty and the
        watchdog flushes once per interval — the Go master snapshots to etcd
        the same way (go/master/service.go:207) rather than serializing the
        whole remaining queue on every GetTask/TaskFinished (O(N^2) I/O)."""
        self._dirty = True

    # ---- snapshot / recover (etcd-equivalent persistence) ----

    def _persist(self, raise_on_error=False):
        if not self._snapshot_path:
            return
        # serialized: handler threads and the watchdog all persist on state
        # transitions; concurrent writers sharing one tmp path would race
        with self._persist_lock:
            self._dirty = False
            blob = self._queue.snapshot()
            head = json.dumps({"dataset_set": self._dataset_set}).encode()
            data = len(head).to_bytes(8, "little") + head + blob
            try:
                # fsync'd temp + rename, previous generation kept as .bak:
                # a crash mid-write can tear only the temp file, and a
                # snapshot later found corrupt still has a fallback
                fault.atomic_write(self._snapshot_path, data,
                                   site="master.snapshot", backup=True)
            except (OSError, fault.FaultInjected) as e:
                # a failed snapshot write must not kill the serving
                # master; stay dirty so the watchdog retries next tick.
                # shutdown() has no next tick — there it must propagate
                self._dirty = True
                if raise_on_error:
                    raise
                warnings.warn("master snapshot write failed (will retry): "
                              "%s" % e, RuntimeWarning)

    def recover(self):
        """Restore from the snapshot, falling back to the previous
        generation (``.bak``) when the newest one is truncated/corrupt —
        a poisoned snapshot must never brick the master. Returns the
        path restored from, or None when neither generation is usable."""
        for path in (self._snapshot_path, self._snapshot_path + ".bak"):
            if not os.path.exists(path):
                continue
            try:
                with open(path, "rb") as f:
                    raw = f.read()
                hlen = int.from_bytes(raw[:8], "little")
                if not 0 < hlen <= len(raw) - 8:
                    raise ValueError("truncated snapshot header")
                meta = json.loads(raw[8:8 + hlen])
                # validate the meta before mutating the queue: a late
                # failure must not leave half-restored tasks behind a
                # "starting empty" warning
                dataset_set = meta["dataset_set"]
                self._queue.restore(raw[8 + hlen:])
                self._dataset_set = dataset_set
                return path
            except (ValueError, KeyError, OSError, RuntimeError) as e:
                warnings.warn("master snapshot %r unusable (%s); trying "
                              "previous generation" % (path, e),
                              RuntimeWarning)
        warnings.warn("no usable master snapshot under %r; starting empty"
                      % self._snapshot_path, RuntimeWarning)
        return None

    # ---- RPC methods ----

    def rpc_ping(self):
        return "pong"

    def rpc_set_dataset(self, task_payloads=None, files=None,
                        files_per_task=1):
        """Either explicit payload strings, or a shard file list partitioned
        `files_per_task` per task (the Go master partitions recordio chunks;
        shard files are our chunk granularity)."""
        with self._lock:
            if self._dataset_set:
                return {"already_set": True}
            payloads = list(task_payloads or [])
            if files:
                for i in range(0, len(files), files_per_task):
                    payloads.append(json.dumps(
                        {"files": files[i:i + files_per_task]}))
            for p in payloads:
                self._queue.add_task(p.encode())
            self._dataset_set = True
        self._persist()
        return {"num_tasks": len(payloads)}

    def rpc_get_task(self, timeout=None):
        t = self._queue.get_task(
            timeout_s=self._default_lease if timeout is None else timeout)
        if t is None:
            return {"task": None, "all_done": self._queue.all_done()}
        tid, payload = t
        self._mark_dirty()
        return {"task": {"id": tid,
                         "payload": base64.b64encode(payload).decode()}}

    def rpc_task_finished(self, task_id):
        ok = self._queue.task_finished(task_id)
        self._mark_dirty()
        return {"accepted": ok}

    def rpc_task_failed(self, task_id):
        ok = self._queue.task_failed(task_id)
        self._mark_dirty()
        return {"accepted": ok}

    def rpc_counts(self):
        return self._queue.counts()

    def rpc_all_done(self):
        return {"all_done": self._queue.all_done()}

    def rpc_request_save_model(self, trainer_id, block_dur=60.0):
        """Grants the save slot to exactly one trainer per window
        (go/master/service.go:481 semantics)."""
        now = time.time()
        with self._lock:
            holder, expiry = self._save_grant
            if holder is not None and expiry > now and holder != trainer_id:
                return {"granted": False}
            self._save_grant = (trainer_id, now + block_dur)
            return {"granted": True}


class MasterClient:
    """Blocking client; mirrors python/paddle/v2/master/client.py over
    the hardened RPC channel (distributed/rpc.py): per-call deadlines,
    bounded retries with backoff for the idempotent methods, circuit
    breaker. Usable as a context manager.

    Every master method is safely retryable: reads are pure;
    ``task_finished``/``task_failed`` re-ack as not-accepted;
    ``set_dataset`` re-acks ``already_set``; ``request_save_model``
    renews; a ``get_task`` whose response was lost re-leases — the
    orphaned lease re-dispatches at ``lease_timeout`` (the same path a
    dead trainer takes)."""

    def __init__(self, address, connect_timeout=10.0, call_timeout=10.0,
                 max_attempts=3, breaker=None, seed=None):
        # call_timeout keeps the pre-hardening contract: the old client's
        # connect timeout persisted as the socket timeout, so a frozen
        # master raised after ~10s instead of hanging a trainer forever
        self._ch = rpc.RpcChannel(
            address, service="master", connect_timeout=connect_timeout,
            call_timeout=call_timeout, max_attempts=max_attempts,
            breaker=breaker, seed=seed)

    def _call(self, method, **params):
        return self._ch.call(method, params=params, idempotent=True)

    def ping(self):
        return self._call("ping")

    def set_dataset(self, files=None, task_payloads=None, files_per_task=1):
        return self._call("set_dataset", files=files,
                          task_payloads=task_payloads,
                          files_per_task=files_per_task)

    def get_task(self, timeout=None):
        """Returns (task_id, payload bytes) or None when nothing is
        available right now."""
        r = self._call("get_task", timeout=timeout)
        if r["task"] is None:
            return None
        return r["task"]["id"], base64.b64decode(r["task"]["payload"])

    def task_finished(self, task_id):
        return self._call("task_finished", task_id=task_id)["accepted"]

    def task_failed(self, task_id):
        return self._call("task_failed", task_id=task_id)["accepted"]

    def counts(self):
        return self._call("counts")

    def all_done(self):
        return self._call("all_done")["all_done"]

    def request_save_model(self, trainer_id, block_dur=60.0):
        return self._call("request_save_model", trainer_id=trainer_id,
                          block_dur=block_dur)["granted"]

    def tasks(self, lease_timeout=None, poll_interval=0.2):
        """Iterate over (task_id, payload) until the dataset is exhausted;
        the caller MUST report task_finished/task_failed per task (the
        NextRecord pattern of go/master/client.go at task granularity)."""
        while True:
            t = self.get_task(timeout=lease_timeout)
            if t is not None:
                yield t
                continue
            if self.all_done():
                return
            time.sleep(poll_interval)

    def close(self):
        self._ch.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
