"""A RUNNABLE parameter-server mode.

Capability parity: the reference's fluid pserver tier —
`operators/listen_and_serv_op.cc:60-200` (receive fan-in grads with a
trainer barrier, run per-param optimize blocks, serve params back),
`operators/detail/grpc_server.h:45`, and the sync/async modes of
`distribute_transpiler.py:139` / `dist_train/async_update.md`.

The JAX package's ``distributed/pserver.py`` on the port, with the same
RPC methods, fields and dedup tokens, so a port trainer pushes to a JAX
package server and the other way round. The production path is data
parallelism with sharded optimizer state (``ParallelExecutor``); this
module exists for the OTHER capability the reference has: serving
parameters from CPU hosts to heterogeneous trainers over a network — the
same TCP-RPC transport as the elastic master, a per-param fan-in barrier
in sync mode, and apply-on-arrival in async mode. The server holds numpy
arrays on the host; ``RemoteTrainer`` runs its step on its executor's
device (the card unless it is given a CPU executor) and puts the pulled
parameters there.
"""

import base64
import threading
import uuid

import numpy as np
import socketserver
import torch

from paddle_tpu_torch.distributed import rpc
from paddle_tpu_torch.recordio_writer import host_array

__all__ = ["ParameterServer", "PServerClient", "sgd_update",
           "momentum_update"]


def sgd_update(lr):
    def fn(param, grad, state):
        return param - lr * grad, state
    return fn


def momentum_update(lr, mu=0.9):
    def fn(param, grad, state):
        v = state.get("velocity")
        v = mu * (v if v is not None else 0.0) + grad
        state["velocity"] = v
        return param - lr * v, state
    return fn


class ParameterServer(rpc.FederationRpcMixin):
    """Holds a shard of parameters; trainers push grads and pull params.

    sync mode: a parameter updates once ALL ``trainers`` grads for the
    round arrive (summed, like the reference's fan-in + merge-add), and
    send_grad blocks until the round's update is applied — the
    listen_and_serv barrier. async mode: each grad applies immediately.
    """

    fleet_role = "pserver"

    def __init__(self, address=("127.0.0.1", 0), trainers=1,
                 optimizer=None, sync_mode=True):
        self._params = {}
        self._state = {}        # per-param optimizer state dict
        self._pending = {}      # name -> {trainer_id: grad}
        self._round = {}        # name -> round counter
        self._poisoned = {}     # name -> error message (aborts a round)
        self._seen_seq = {}  # (name, trainer_id, seq) -> round, FIFO-capped
        self._cv = threading.Condition()
        self._trainers = trainers
        self._opt = optimizer or sgd_update(0.01)
        self._sync = sync_mode
        self._stop = threading.Event()

        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                rpc.serve_stream(outer, "pserver", self.rfile,
                                 self.connection, outer._stop)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(address, Handler)
        self.address = self._server.server_address

    def start(self):
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self

    def shutdown(self):
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._server.shutdown()
        self._server.server_close()

    # ---- RPC ----

    def rpc_init_param(self, name, value, shape, dtype):
        with self._cv:
            self._params[name] = np.frombuffer(
                base64.b64decode(value), dtype=dtype).reshape(shape).copy()
            self._state[name] = {}
        return {}

    def rpc_send_grad(self, name, value, shape, dtype, trainer_id,
                      seq=None):
        """Apply (async) or fan-in (sync) one gradient. ``seq`` is the
        client's per-connection push counter: a retransmit of an
        already-accepted push (the response was lost to a connection
        drop) is acknowledged WITHOUT re-applying, making send_grad
        safely retryable — at-least-once delivery, exactly-once apply."""
        grad = np.frombuffer(base64.b64decode(value),
                             dtype=dtype).reshape(shape)
        with self._cv:
            if name not in self._params:
                raise KeyError("unknown parameter %r" % name)
            # one dedup entry PER PUSH (seq carries the client's unique
            # token, "token.N"): concurrent pushes from one client and
            # clients sharing a trainer_id each keep their own entry, so
            # no interleaving can evict the entry a retransmit needs. An
            # entry only matters during its push's bounded retry window
            # — a client never retransmits seq N after moving past it —
            # so FIFO eviction is safe PROVIDED the cap exceeds the keys
            # one sync round can generate (trainers x params, all of
            # whose entries stay hot until the round's barrier clears)
            key = (name, trainer_id, seq)
            seen = self._seen_seq.get(key)
            if seq is not None and seen is not None:
                return self._ack_duplicate(name, seen)
            cap = max(4096, 8 * self._trainers * len(self._params))
            if seq is not None and len(self._seen_seq) >= cap:
                self._seen_seq.pop(next(iter(self._seen_seq)))
            if not self._sync:
                p, st = self._opt(self._params[name], grad,
                                  self._state[name])
                self._params[name] = p
                self._state[name] = st
                if seq is not None:
                    self._seen_seq[key] = 0
                return {"applied": True}
            pend = self._pending.setdefault(name, {})
            if trainer_id in pend:
                # poison the round so WAITING trainers also raise instead
                # of hanging at a barrier that can never complete
                msg = ("duplicate grad from trainer_id=%r for %r this "
                       "round (two trainers sharing an id)"
                       % (trainer_id, name))
                self._poisoned[name] = msg
                self._cv.notify_all()
                raise RuntimeError(msg)
            pend[trainer_id] = grad
            my_round = self._round.get(name, 0)
            if seq is not None:
                self._seen_seq[key] = my_round
            if len(pend) >= self._trainers:
                total = np.sum(list(pend.values()), axis=0)
                p, st = self._opt(self._params[name], total,
                                  self._state[name])
                self._params[name] = p
                self._state[name] = st
                self._pending[name] = {}
                self._round[name] = my_round + 1
                self._cv.notify_all()
            else:
                # barrier: wait until some trainer completes the round
                while (self._round.get(name, 0) == my_round
                       and not self._stop.is_set()
                       and name not in self._poisoned):
                    self._cv.wait(timeout=0.1)
                if name in self._poisoned:
                    raise RuntimeError("round aborted: "
                                       + self._poisoned[name])
                if self._round.get(name, 0) == my_round:
                    raise RuntimeError(
                        "parameter server shut down mid-round; grad for "
                        "%r was NOT applied" % name)
        return {"applied": True}

    def _ack_duplicate(self, name, accepted_round):
        """Ack a retransmitted push without re-applying. In sync mode,
        wait for the round the original joined to complete first (the
        same barrier the original send observed). Caller holds _cv."""
        if not self._sync:
            return {"applied": True, "duplicate": True}
        while (self._round.get(name, 0) <= accepted_round
               and not self._stop.is_set()
               and name not in self._poisoned):
            self._cv.wait(timeout=0.1)
        if name in self._poisoned:
            raise RuntimeError("round aborted: " + self._poisoned[name])
        if self._round.get(name, 0) <= accepted_round:
            raise RuntimeError(
                "parameter server shut down mid-round; grad for %r was "
                "NOT applied" % name)
        return {"applied": True, "duplicate": True}

    def rpc_get_param(self, name):
        with self._cv:
            p = self._params[name]
        return {"value": base64.b64encode(p.tobytes()).decode("ascii"),
                "shape": list(p.shape), "dtype": str(p.dtype)}

    def rpc_param_names(self):
        with self._cv:
            return {"names": sorted(self._params)}


class PServerClient:
    def __init__(self, address, timeout=None, max_attempts=3,
                 breaker=None, seed=None):
        """``timeout=None`` blocks indefinitely on RPCs: sync-mode
        send_grad waits at the server barrier for straggler trainers
        (whose first step may include minutes of compilation).

        Built on the hardened channel: every method is idempotent and
        retried with backoff — ``send_grad`` carries a per-client
        sequence number the server dedups on, so a retransmitted push is
        acked without double-applying (see ``rpc_send_grad``)."""
        self._ch = rpc.RpcChannel(
            address, service="pserver", connect_timeout=30.0,
            call_timeout=timeout, max_attempts=max_attempts,
            breaker=breaker, seed=seed)
        self._seq_lock = threading.Lock()
        self._seq = 0
        # process-unique client token: id(self) would be reused by the
        # allocator after this client is freed, and a recreated client's
        # first push could then be falsely deduped as a retransmit
        self._token = uuid.uuid4().hex

    def _call(self, method, **params):
        return self._ch.call(method, params=params, idempotent=True)

    def init_param(self, name, array):
        a = np.asarray(array)
        return self._call(
            "init_param", name=name,
            value=base64.b64encode(a.tobytes()).decode("ascii"),
            shape=list(a.shape), dtype=str(a.dtype))

    def send_grad(self, name, grad, trainer_id=0):
        g = np.asarray(grad)
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        return self._call(
            "send_grad", name=name,
            value=base64.b64encode(g.tobytes()).decode("ascii"),
            shape=list(g.shape), dtype=str(g.dtype),
            trainer_id=trainer_id, seq="%s.%d" % (self._token, seq))

    def get_param(self, name):
        r = self._call("get_param", name=name)
        return np.frombuffer(base64.b64decode(r["value"]),
                             dtype=r["dtype"]).reshape(r["shape"]).copy()

    def param_names(self):
        return self._call("param_names")["names"]

    def close(self):
        self._ch.close()


def _is_optimizer_op(op):
    return "Param" in op.inputs and "Grad" in op.inputs


def strip_optimizer_ops(program):
    """Trainer half of the transpile (reference
    distribute_transpiler.py:311 get_trainer_program): remove the update
    ops — grads are shipped to the parameter server instead. Returns
    (trainer_program, [(param_name, grad_name)])."""
    trainer = program.clone()
    block = trainer.global_block()
    pg = []
    kept = []
    for op in block.ops:
        if _is_optimizer_op(op):
            pg.append((op.inputs["Param"][0], op.inputs["Grad"][0]))
        else:
            kept.append(op)
    block.ops = kept
    trainer._bump_version()
    return trainer, pg


class RemoteTrainer:
    """Drives one trainer against ParameterServer shards: run the
    optimizer-stripped program, push grads (blocking on the sync barrier),
    pull updated params into the scope — the send_vars -> send_barrier ->
    recv sequence of the reference trainer program
    (distribute_transpiler.py:139)."""

    def __init__(self, program, endpoints, trainer_id=0, exe=None,
                 scope=None, init_params=False):
        from paddle_tpu_torch.core.executor import Executor
        from paddle_tpu_torch.core.scope import global_scope
        from paddle_tpu_torch.parallel.distribute import round_robin

        self.exe = exe or Executor()
        self.scope = scope if scope is not None else global_scope()
        self.trainer_id = trainer_id
        self.trainer_program, self.params_grads = strip_optimizer_ops(
            program)
        params = [p for p, _ in self.params_grads]
        self.shard_of = dict(zip(params, round_robin(params, endpoints)))
        self.clients = {ep: PServerClient(_parse_ep(ep))
                        for ep in set(self.shard_of.values())}
        if init_params:
            for p in params:
                self.clients[self.shard_of[p]].init_param(
                    p, host_array(self.scope.find_var(p))[0])

    def step(self, feed, fetch_list=()):
        grads = [g for _, g in self.params_grads]
        outs = self.exe.run(self.trainer_program, feed=feed,
                            fetch_list=list(fetch_list) + grads,
                            scope=self.scope)
        fetched = outs[: len(fetch_list)]
        for (p, _), g in zip(self.params_grads, outs[len(fetch_list):]):
            self.clients[self.shard_of[p]].send_grad(
                p, np.asarray(g), trainer_id=self.trainer_id)
        for p, _ in self.params_grads:
            self.scope.set_var(p, torch.from_numpy(
                self.clients[self.shard_of[p]].get_param(p)).to(
                    self.exe.device))
        return fetched

    def close(self):
        for c in self.clients.values():
            c.close()


def _parse_ep(ep):
    if isinstance(ep, tuple):
        return ep
    host, port = ep.rsplit(":", 1)
    return (host, int(port))
