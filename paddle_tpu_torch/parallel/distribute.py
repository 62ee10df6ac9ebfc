"""Distributed training: the process group and the pserver capability.

Capability parity: the JAX package's ``parallel/distribute.py``
(`python/paddle/fluid/distribute_transpiler.py`, the gRPC pserver tier,
`listen_and_serv_op`). The JAX package brings hosts up through
``jax.distributed``; the port runs one process a rank over
``torch.distributed``: NCCL between CUDA devices, gloo on the CPU, with
the rendezvous by a file store or a loopback TCP address, never over a
network the caller did not name.

``DistributeTranspiler`` keeps the reference's API shape: the trainer
program is the original program (every rank runs it under
``ParallelExecutor``, which owns the gradient exchange), and
``get_pserver_program(endpoint)`` builds the runnable update program of
the parameters an endpoint owns, byte for byte the JAX package's.
"""

import datetime

import torch
import torch.distributed as dist

from paddle_tpu_torch.core import ir

__all__ = ["DistributeTranspiler", "init_multihost", "round_robin",
           "hash_name", "global_batch_feed", "HostLocalBatch"]


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, device=None, timeout_s=300):
    """Join this process to a ``torch.distributed`` world of
    ``num_processes`` ranks as rank ``process_id``.

    ``coordinator_address``: ``"host:port"`` (a TCP rendezvous, e.g.
    ``"localhost:29500"``), ``"file:///path"`` (a file store shared by
    the ranks), or ``"tcp://..."``. The backend is NCCL when ``device``
    is a CUDA device (the card, the default) and gloo when it is the
    CPU. An NCCL world binds this rank to its device and runs one
    collective at once, so that a CUDA graph may capture the next ones.
    ``timeout_s`` bounds the rendezvous and every collective.

    A world of one process is made too when asked for (the card holds
    one rank): every collective then runs, and sums one addend. With
    ``num_processes`` None nothing is made and False is returned, as the
    JAX package returns for one host."""
    if num_processes is None:
        return False
    if dist.is_initialized():
        return True
    if device is None:
        device = torch.device("cuda", int(process_id or 0)
                              % max(torch.cuda.device_count(), 1)) \
            if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    addr = coordinator_address or "localhost:29500"
    if not addr.startswith(("tcp://", "file://", "env://")):
        addr = "tcp://" + addr
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(
        backend, init_method=addr, world_size=int(num_processes),
        rank=int(process_id or 0),
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    if backend == "nccl":
        # the communicator is made by the first collective: make it now,
        # outside any graph capture
        t = torch.zeros(1, device=device)
        dist.all_reduce(t)
        torch.cuda.synchronize(device)
    return True


def round_robin(var_names, pserver_endpoints):
    """Reference distributed_splitter.py:16 — round-robin var placement."""
    eplist = []
    for i, _ in enumerate(var_names):
        eplist.append(pserver_endpoints[i % len(pserver_endpoints)])
    return eplist


def hash_name(var_names, pserver_endpoints):
    """Reference distributed_splitter.py:37 — hash-based var placement."""
    def _hash_block(block_str, total):
        return hash(block_str) % total
    return [pserver_endpoints[_hash_block(n, len(pserver_endpoints))]
            for n in var_names]


class DistributeTranspiler:
    def __init__(self, slice_var_up=True):
        self.slice_var_up = slice_var_up
        self.trainer_id = 0
        self.trainers = 1
        self.pserver_endpoints = []
        self.param_shards = {}     # param name -> endpoint (shard owner)
        self._program = None

    def transpile(self, trainer_id, program=None, pservers="127.0.0.1:6174",
                  trainers=1, sync_mode=True, startup_program=None):
        """Record the trainer's id and the parameters' owners. The
        process group itself is ``init_multihost``'s: the transpiler
        names no rendezvous and contacts nothing."""
        self._program = program or ir.default_main_program()
        self.trainer_id = trainer_id
        self.trainers = trainers
        self.pserver_endpoints = [e for e in pservers.split(",") if e]
        params = [p.name for p in self._program.global_block().all_parameters()]
        eplist = round_robin(params, self.pserver_endpoints) \
            if self.pserver_endpoints else []
        self.param_shards = dict(zip(params, eplist))
        # the executable form of the pserver state distribution is
        # ParallelExecutor's ZeRO-1 sharding of every accumulator tagged
        # `optimizer_state_for`; state_shard_of mirrors the ownership
        n_shards = max(len(self.pserver_endpoints), 1)
        self.state_shard_of = {p: i % n_shards for i, p in enumerate(params)}

    def get_trainer_program(self):
        """Every rank runs the same program; the gradient exchange is
        ``ParallelExecutor``'s, so the trainer program IS the original
        program."""
        return self._program

    def get_pserver_program(self, endpoint):
        """A RUNNABLE update program for the params this endpoint owns
        (`distribute_transpiler.py:319`: per-param optimize blocks): the
        trainer program's optimizer ops whose Param this endpoint owns,
        with the ops that compute their non-persistable inputs (a
        decayed learning rate), cloned into a fresh Program; gradients
        become feed vars, params, accumulators and the lr stay
        persistable state. ``prog.pserver_meta`` carries the ownership
        table."""
        owned = {p for p, ep in self.param_shards.items() if ep == endpoint}
        prog = ir.Program()
        dst = prog.global_block()
        src = self._program.global_block()
        update_ops = [op for op in src.ops
                      if op.inputs.get("Param")
                      and op.inputs["Param"][0] in owned]
        update_ids = {id(op) for op in update_ops}
        producer = {}
        for op in src.ops:
            for n in op.output_arg_names:
                producer[n] = op
        cloned, prologue = set(), []

        def need(n):
            # chase the producer of temps and of state the main program
            # advances itself (the lr-decay step counter); state only the
            # update ops write stays with the scope
            if n.endswith(ir.GRAD_SUFFIX):
                return
            op = producer.get(n)
            if op is None or id(op) in cloned or id(op) in update_ids:
                return
            cloned.add(id(op))
            for m in op.input_arg_names:
                if m:
                    need(m)
            prologue.append(op)

        for op in update_ops:
            for n in op.input_arg_names:
                if n:
                    need(n)

        for op in prologue + update_ops:
            for n in list(op.input_arg_names) + list(op.output_arg_names):
                if not n or dst.has_var_local(n):
                    continue
                v = src.var(n)
                is_grad = n.endswith(ir.GRAD_SUFFIX)
                dst.create_var(
                    name=n, shape=v.shape, dtype=v.dtype,
                    persistable=getattr(v, "persistable", False)
                    or (not is_grad and producer.get(n) is None),
                    is_data=is_grad)
            dst.append_op(op.type,
                          {k: list(v) for k, v in op.inputs.items()},
                          {k: list(v) for k, v in op.outputs.items()},
                          dict(op.attrs))
        prog.pserver_meta = {"endpoint": endpoint,
                             "params": sorted(owned),
                             "mode": "reference-pserver-update-program"}
        return prog

    def get_startup_program(self, endpoint=None, pserver_program=None):
        return ir.default_startup_program()


class HostLocalBatch:
    """A feed value that is already this rank's rows (``global_batch_
    feed``): ``ParallelExecutor`` feeds it as is, where it cuts its own
    rows out of any other value."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __repr__(self):
        return "HostLocalBatch(%r)" % (getattr(self.value, "shape", None),)


def global_batch_feed(mesh, feed, batch_axis="dp"):
    """Multihost feeding: mark each rank's HOST-LOCAL batch as its share
    of the global batch, so the executor does not cut it again (the
    reference's per-trainer data feeding). The global batch is the ranks'
    rows in mesh order, and fetches come back global."""
    if batch_axis not in mesh.axis_names:
        raise ValueError("global_batch_feed: the mesh has no %r axis"
                         % (batch_axis,))
    return {k: v if isinstance(v, HostLocalBatch) else HostLocalBatch(v)
            for k, v in feed.items()}
