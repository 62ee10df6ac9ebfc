"""Membership / discovery / election service — the etcd redesign.

Capability parity: the reference's etcd layer (`go/pserver/etcd_client.go`
pserver self-registration under TTL leases, `go/master/etcd_client.go`
distributed lock/election, client-side endpoint discovery in
`go/pserver/client/etcd_client.go`). Redesigned as a small in-process
service over the same TCP-RPC transport as the elastic master: members
register (kind, name, endpoint) under a TTL lease and heartbeat to keep it;
discovery lists live members; election grants a renewable leadership lease
per key. Nothing here touches the device path — like etcd, it is pure
control plane.

Elasticity (the Go elastic master's dynamic trainer counts): the server
carries a monotonically increasing **cluster epoch**, bumped whenever the
member SET actually changes — a new registration, a deregistration, or a
lease-expiry sweep (renewals and re-registrations of a live member do
not bump it). The epoch is persisted with the snapshot, so a restarted
control plane never hands out an epoch the trainers have already seen.
Trainers learn of changes through ``rpc_epoch`` — a bounded long-poll
that parks the connection thread until the epoch moves past the caller's
known value — surfaced client-side as ``MembershipClient.watch_epoch``
and, for training loops that must never block on the control plane, the
``EpochWatcher`` background thread (``distributed/recovery.py``'s
``ElasticRecoveryLoop`` reads it between chunk dispatches).

The JAX package's ``distributed/membership.py`` on the port: the same
RPC methods, fields, snapshot files and fault sites, so either
package's client talks to either package's server.

Fault site: ``membership.lease.<kind>.<name>`` fires inside the server's
heartbeat handler before the lease is renewed — a drop rule there is an
injected lease expiry for exactly that member (the beats fail, the sweep
removes it, the epoch bumps), the worker-loss seam the elastic chaos
tests drive.
"""

import json
import os
import socketserver
import threading
import time
import warnings

from paddle_tpu_torch import fault
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.distributed import rpc

__all__ = ["MembershipServer", "MembershipClient", "EpochWatcher",
           "shared_watchers"]

#: hard cap on one rpc_epoch long-poll (clients re-issue; an unbounded
#: park would pin a handler thread to a vanished client forever)
MAX_EPOCH_WAIT = 30.0


class MembershipServer(rpc.FederationRpcMixin):
    fleet_role = "membership"
    def __init__(self, address=("127.0.0.1", 0), default_ttl=10.0,
                 sweep_interval=0.5, snapshot_path=None):
        self._members = {}   # (kind, name) -> {endpoint, expires}
        self._leaders = {}   # key -> {name, expires}
        self._epoch = 0      # bumps only when the member SET changes
        self._lock = threading.Lock()
        self._epoch_cond = threading.Condition(self._lock)
        self._default_ttl = default_ttl
        self._sweep_interval = sweep_interval
        self._snapshot_path = snapshot_path
        self._dirty = False
        self._persist_lock = threading.Lock()
        self._stop = threading.Event()

        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                rpc.serve_stream(outer, "membership", self.rfile,
                                 self.connection, outer._stop)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(address, Handler)
        self.address = self._server.server_address

    # ---- lifecycle ----

    def start(self):
        if self._snapshot_path and os.path.exists(self._snapshot_path):
            self.recover()
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        threading.Thread(target=self._sweep, daemon=True).start()
        return self

    def shutdown(self):
        self._stop.set()
        with self._lock:
            # wake parked rpc_epoch long-polls so their handler threads
            # observe _stop instead of sleeping out their full wait
            self._epoch_cond.notify_all()
        self._server.shutdown()
        self._server.server_close()
        self._persist()

    def _bump_epoch_locked(self):
        """Caller holds self._lock: the member set changed."""
        self._epoch += 1
        self._dirty = True
        self._epoch_cond.notify_all()
        if telemetry.enabled():
            telemetry.record_cluster_epoch(self._epoch)

    def _sweep(self):
        while not self._stop.wait(self._sweep_interval):
            now = time.monotonic()
            with self._lock:
                dead = [k for k, m in self._members.items()
                        if m["expires"] <= now]
                for k in dead:
                    del self._members[k]
                gone = [k for k, l in self._leaders.items()
                        if l["expires"] <= now]
                for k in gone:
                    del self._leaders[k]
                if dead:
                    # expired leases change the member set: one epoch
                    # bump per sweep batch (a trainer resharding for the
                    # batch sees every loss at once)
                    self._bump_epoch_locked()
                elif gone:
                    self._dirty = True
            if self._dirty:
                self._persist()

    # ---- snapshot / recover (same pattern as MasterServer: debounced
    # file persistence standing in for etcd's replicated state,
    # go/master/etcd_client.go) ----

    def _persist(self):
        if not self._snapshot_path:
            return
        now_mono, now_wall = time.monotonic(), time.time()
        with self._persist_lock:
            # snapshot the state under the RPC lock, but do the disk IO
            # holding only the persist lock — heartbeats keep _dirty set
            # whenever a client is alive, so the sweep persists every
            # interval and a slow filesystem must not stall the control
            # plane (or push heartbeats past their TTL)
            with self._lock:
                self._dirty = False
                state = {
                    "wall": now_wall,
                    "epoch": self._epoch,
                    # monotonic deadlines don't survive a restart: store
                    # the REMAINING ttl and re-anchor on recover
                    "members": [
                        [k[0], k[1], m["endpoint"],
                         m["expires"] - now_mono]
                        for k, m in self._members.items()],
                    "leaders": [
                        [key, l["name"], l["expires"] - now_mono]
                        for key, l in self._leaders.items()],
                }
            try:
                # fsync'd temp + os.replace (and the torn-write injection
                # seam): a crash mid-write can never leave a truncated
                # snapshot under the live path
                fault.atomic_write(self._snapshot_path,
                                   json.dumps(state).encode(),
                                   site="membership.snapshot")
            except (OSError, fault.FaultInjected) as e:
                self._dirty = True  # sweep retries next interval
                warnings.warn("membership snapshot write failed (will "
                              "retry): %s" % e, RuntimeWarning)

    def recover(self):
        """Restore leases from the snapshot. Membership is soft state —
        every lease re-establishes itself within one heartbeat — so a
        corrupt/truncated snapshot degrades to a cold start, never a
        crash."""
        try:
            with open(self._snapshot_path) as f:
                state = json.load(f)
            # validate the full shape before touching live state: a
            # snapshot from a different version that parses as JSON but
            # unpacks differently must also degrade to a cold start
            elapsed = max(0.0, time.time() - state["wall"])
            members = [(kind, name, endpoint, remain)
                       for kind, name, endpoint, remain in state["members"]]
            leaders = [(key, name, remain)
                       for key, name, remain in state["leaders"]]
            # pre-epoch snapshots (older versions) recover as epoch 0
            epoch = int(state.get("epoch", 0))
        except (OSError, ValueError, KeyError, TypeError) as e:
            warnings.warn("membership snapshot %r unusable (%s); starting "
                          "empty" % (self._snapshot_path, e),
                          RuntimeWarning)
            return
        now = time.monotonic()
        with self._lock:
            # adopt the snapshot's epoch (never regress a live one): a
            # restarted control plane must not re-issue epoch numbers
            # trainers keyed reshard decisions on
            self._epoch = max(self._epoch, epoch)
            for kind, name, endpoint, remain in members:
                if remain - elapsed > 0:
                    self._members[(kind, name)] = {
                        "endpoint": endpoint,
                        "expires": now + remain - elapsed}
            for key, name, remain in leaders:
                if remain - elapsed > 0:
                    self._leaders[key] = {"name": name,
                                          "expires": now + remain - elapsed}

    # ---- RPC methods ----

    def rpc_register(self, kind, name, endpoint, ttl=None):
        ttl = ttl or self._default_ttl
        now = time.monotonic()
        with self._lock:
            joined = (kind, name) not in self._members
            self._members[(kind, name)] = {
                "endpoint": endpoint,
                "expires": now + ttl,
                "last_beat": now}
            if joined:
                self._bump_epoch_locked()
            else:
                self._dirty = True
            epoch = self._epoch
        return {"ttl": ttl, "epoch": epoch}

    def rpc_heartbeat(self, kind, name, ttl=None):
        if fault._active:
            # injected lease expiry: a drop rule on this member-scoped
            # site rejects its beats server-side; the sweep then removes
            # the member and bumps the epoch — deterministic worker loss
            fault.fire("membership.lease.%s.%s" % (kind, name))
        ttl = ttl or self._default_ttl
        now = time.monotonic()
        with self._lock:
            m = self._members.get((kind, name))
            if m is None:
                # a beat racing a deregister (or arriving after a sweep)
                # must NOT re-create the lease: the member is gone until
                # its owner explicitly re-registers
                return {"alive": False}
            m["expires"] = now + ttl
            # heartbeat age = observed inter-beat interval; a member
            # whose gauge creeps toward its ttl is about to be swept
            age = now - m.get("last_beat", now)
            m["last_beat"] = now
            self._dirty = True
        if telemetry.enabled():
            telemetry.record_heartbeat_age(kind, name, age)
        return {"alive": True}

    def rpc_deregister(self, kind, name):
        with self._lock:
            if self._members.pop((kind, name), None) is not None:
                self._bump_epoch_locked()
        return {}

    def rpc_epoch(self, known=None, wait=0.0, kind=None):
        """Current cluster epoch; with ``known`` + ``wait`` a bounded
        long-poll that parks this connection's handler thread until the
        epoch moves past ``known`` (or the wait elapses / the server
        stops). Trainers learn of membership changes within one RPC
        round-trip of the bump instead of tight-polling discover().

        With ``kind`` the reply also carries that kind's live member
        list, read UNDER THE SAME LOCK as the epoch — the atomic
        ``(epoch, members)`` pair elastic reshard decisions key on (a
        separate discover round-trip could pair epoch N with epoch
        N+1's members and trigger a redundant reshard)."""
        deadline = time.monotonic() + min(float(wait or 0.0),
                                          MAX_EPOCH_WAIT)
        with self._lock:
            while (known is not None and self._epoch <= int(known)
                   and not self._stop.is_set()):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._epoch_cond.wait(min(remaining, 0.5))
            out = {"epoch": self._epoch}
            if kind is not None:
                now = time.monotonic()
                out["members"] = sorted(
                    (name, m["endpoint"])
                    for (k, name), m in self._members.items()
                    if k == kind and m["expires"] > now)
            return out

    def rpc_discover(self, kind):
        now = time.monotonic()
        with self._lock:
            out = sorted(
                (name, m["endpoint"])
                for (k, name), m in self._members.items()
                if k == kind and m["expires"] > now)
        return {"members": out}

    def rpc_elect(self, key, name, ttl=None):
        """First candidate wins and holds the lease; re-electing as the
        current leader renews it (the Go master's etcd lock)."""
        ttl = ttl or self._default_ttl
        now = time.monotonic()
        with self._lock:
            cur = self._leaders.get(key)
            if cur is None or cur["expires"] <= now or cur["name"] == name:
                self._leaders[key] = {"name": name,
                                      "expires": now + ttl}
                self._dirty = True
                return {"leader": name, "is_leader": True}
            return {"leader": cur["name"], "is_leader": False}

    def rpc_resign(self, key, name):
        with self._lock:
            cur = self._leaders.get(key)
            if cur is not None and cur["name"] == name:
                del self._leaders[key]
                self._dirty = True
                return {"resigned": True}
        return {"resigned": False}


class MembershipClient:
    """Client over the hardened RPC channel (distributed/rpc.py).

    Every membership method is idempotent — register/heartbeat/elect
    renew leases, deregister/resign of an absent entry are no-ops,
    discover is pure — so all calls ride the channel's bounded retries
    with backoff, and a flapping control plane trips the circuit breaker
    instead of hanging trainers."""

    def __init__(self, address, heartbeat_interval=2.0,
                 call_timeout=10.0, max_attempts=3, breaker=None, seed=None):
        self._ch = rpc.RpcChannel(
            address, service="membership", connect_timeout=10.0,
            call_timeout=call_timeout, max_attempts=max_attempts,
            breaker=breaker, seed=seed)
        self._hb_interval = heartbeat_interval
        self._beats = {}          # (kind, name) -> (stop Event, Thread)
        self._beats_lock = threading.Lock()
        self._closed = threading.Event()

    def _call(self, method, timeout=None, **params):
        return self._ch.call(method, params=params, idempotent=True,
                             timeout=timeout)

    def register(self, kind, name, endpoint, ttl=None, heartbeat=True):
        """Register and (optionally) keep the lease alive from a daemon
        thread — the pserver etcd self-registration pattern. The beat
        thread is scoped to THIS registration: ``deregister``/``close``
        stop it, and a server-side "not alive" answer (the lease was
        swept, or deregistered elsewhere) terminates it rather than
        letting a zombie beat keep a later re-registration of the same
        name alive on a dead owner's behalf."""
        if self._closed.is_set():
            # a post-close register would repopulate _beats with a
            # thread no later close() will ever stop
            raise RuntimeError("MembershipClient is closed")
        # ANY re-registration replaces the previous one's beat — also
        # with heartbeat=False (the caller taking over manual lease
        # management), where a surviving old beat would keep renewing
        # the new lease on the old owner's behalf
        self._stop_beat(kind, name)
        out = self._call("register", kind=kind, name=name,
                         endpoint=endpoint, ttl=ttl)
        if heartbeat:
            # beat well inside the lease (ttl/3) or the lease dies between
            # beats
            interval = self._hb_interval
            if ttl:
                interval = min(interval, ttl / 3.0)
            stop = threading.Event()

            def beat():
                while not stop.wait(interval):
                    if self._closed.is_set():
                        return
                    try:
                        r = self._call("heartbeat", kind=kind, name=name,
                                       ttl=ttl)
                    except rpc.RpcError:
                        # the channel already retried with backoff; a
                        # still-dead server means the lease is lost —
                        # the owner must re-register, not us
                        return
                    if not r.get("alive"):
                        # the server no longer knows this lease
                        # (deregistered or swept): beating on could only
                        # resurrect a NAME someone else may now own
                        return

            t = threading.Thread(target=beat, daemon=True,
                                 name="membership-beat-%s-%s"
                                      % (kind, name))
            with self._beats_lock:
                self._beats[(kind, name)] = (stop, t)
            t.start()
        return out

    def _stop_beat(self, kind, name, join_timeout=5.0):
        with self._beats_lock:
            entry = self._beats.pop((kind, name), None)
        if entry is None:
            return
        stop, t = entry
        stop.set()
        t.join(join_timeout)

    def deregister(self, kind, name):
        # stop OUR beat before the server forgets the lease: a beat
        # landing after the deregister is answered alive=False (the
        # server never re-creates the lease), but leaving the thread
        # running would keep a LATER re-registration of the same name
        # alive from this dead owner
        self._stop_beat(kind, name)
        return self._call("deregister", kind=kind, name=name)

    def discover(self, kind):
        return self._call("discover", kind=kind)["members"]

    def epoch(self):
        """Current cluster epoch (no blocking)."""
        return self._call("epoch")["epoch"]

    def watch_epoch(self, known=None, wait=10.0):
        """Long-poll the cluster epoch: returns as soon as it exceeds
        ``known`` (immediately when it already does, or when ``known``
        is None), else after ``wait`` seconds with the unchanged value.
        The call timeout is budgeted ABOVE the server-side wait so a
        healthy-but-quiet cluster is not misread as a dead one."""
        wait = min(float(wait), MAX_EPOCH_WAIT)
        return self._call("epoch", known=known, wait=wait,
                          timeout=wait + 10.0)["epoch"]

    def watch_world(self, kind, known=None, wait=10.0):
        """``watch_epoch`` returning the ATOMIC ``(epoch, members)``
        pair — both read under one server lock, so a reshard decision
        can never pair an epoch with a different epoch's member list."""
        wait = min(float(wait), MAX_EPOCH_WAIT)
        out = self._call("epoch", known=known, wait=wait, kind=kind,
                         timeout=wait + 10.0)
        return out["epoch"], tuple(out["members"])

    def elect(self, key, name, ttl=None):
        return self._call("elect", key=key, name=name, ttl=ttl)

    def resign(self, key, name):
        return self._call("resign", key=key, name=name)

    def close(self):
        """Stop every heartbeat thread (joined, so none can beat after
        close returns) and drop the channel."""
        self._closed.set()
        with self._beats_lock:
            beats = list(self._beats.items())
            self._beats.clear()
        for _, (stop, t) in beats:
            stop.set()
        for _, (stop, t) in beats:
            t.join(5.0)
        self._ch.close()


#: process-level shared-watcher registry: (host, port, kind) ->
#: [watcher, refcount]. One long-poll channel per (endpoint, kind) per
#: process no matter how many consumers (serving router + elastic loop
#: + anything else) watch it — see EpochWatcher.shared().
_shared_watchers = {}
_shared_watchers_lock = threading.Lock()


def shared_watchers():
    """Snapshot of the shared-watcher registry: {(host, port, kind):
    refcount}. Empty when every consumer released its watcher — the
    test suite's leak guard asserts exactly that at session end."""
    with _shared_watchers_lock:
        return {k: v[1] for k, v in _shared_watchers.items()}


class EpochWatcher:
    """Background long-poll on the cluster epoch + member list, for
    training loops that must never block on the control plane: the
    ``ElasticRecoveryLoop`` reads ``watcher.epoch`` (an attribute, no
    RPC) between chunk dispatches and reshards when it moved.

    Owns its OWN client/channel: the watcher thread parks inside
    ``watch_epoch`` for seconds at a time, and sharing a channel would
    serialize the trainer's register/heartbeat traffic behind it.

    Consumers that can coexist (the serving router and the elastic
    recovery loop in one process) should acquire through ``shared()``
    instead of constructing directly: one watcher (one channel, one
    parked server thread) per (endpoint, kind) per process, refcounted
    so the last ``stop()`` tears it down. ``snapshot()`` is the whole
    read API and is safe from any number of threads."""

    def __init__(self, address, kind="trainer", wait=5.0, seed=None):
        self._shared_key = None   # set by shared(); None = sole owner
        self._client = MembershipClient(address, seed=seed)
        self.kind = kind
        self._wait = wait
        self._stop = threading.Event()
        self._lock = threading.Lock()
        try:
            # wait=0: an immediate atomic (epoch, members) read
            self.epoch, self.members = self._client.watch_world(
                kind, wait=0.0)
        except BaseException:
            # the watcher never materialized: close the channel instead
            # of leaking one socket per failed construction attempt
            self._client.close()
            raise
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="membership-epoch-watcher")
        self._thread.start()

    def _watch(self):
        backoff = 0.05
        while not self._stop.is_set():
            try:
                # epoch + members arrive as ONE lock-consistent pair:
                # a change landing between two separate calls could
                # pair epoch N with epoch N+1's members and trigger a
                # redundant reshard
                e, members = self._client.watch_world(
                    self.kind, known=self.epoch, wait=self._wait)
                if e != self.epoch:
                    with self._lock:
                        self.members = members
                        self.epoch = e
                backoff = 0.05
            except rpc.RpcError:
                # flapping control plane: the channel already retried
                # and the breaker bounds the damage; keep watching (the
                # trainer keeps training on the world it knows) with a
                # growing pause so a hard-down server costs one failed
                # call per backoff, not a busy loop
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, 2.0)

    @classmethod
    def shared(cls, address, kind="trainer", wait=5.0, seed=None):
        """Acquire the process-shared watcher for ``(address, kind)``,
        creating it on first use. Every ``shared()`` must be balanced
        by exactly one ``stop()`` on the returned watcher: stop
        decrements the refcount and only the LAST consumer's stop
        closes the channel and joins the thread — so a router shutting
        down cannot yank the epoch feed out from under a still-running
        elastic loop (the shutdown race this registry exists to kill).

        The first acquisition performs the initial atomic
        (epoch, members) read while holding the registry lock; a
        concurrent acquire of a DIFFERENT endpoint briefly waits on
        it (bounded by the RPC call timeout)."""
        if isinstance(address, str):
            host, port = address.rsplit(":", 1)
            key = (host, int(port), kind)
        else:
            key = (address[0], int(address[1]), kind)
        with _shared_watchers_lock:
            ent = _shared_watchers.get(key)
            if ent is not None:
                ent[1] += 1
                return ent[0]
            w = cls(address, kind=kind, wait=wait, seed=seed)
            w._shared_key = key
            _shared_watchers[key] = [w, 1]
            return w

    def snapshot(self):
        """(epoch, members) — consistent pair."""
        with self._lock:
            return self.epoch, self.members

    def stop(self):
        """Release this consumer's hold. A directly-constructed
        watcher stops immediately; a ``shared()`` watcher only stops
        once every acquisition released it (call stop exactly once per
        ``shared()``)."""
        key = self._shared_key
        if key is not None:
            with _shared_watchers_lock:
                ent = _shared_watchers.get(key)
                if ent is not None and ent[0] is self:
                    ent[1] -= 1
                    if ent[1] > 0:
                        return
                    del _shared_watchers[key]
        self._stop.set()
        self._client.close()
        self._thread.join(self._wait + 15.0)
