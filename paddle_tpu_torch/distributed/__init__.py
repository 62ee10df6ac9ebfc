"""Elastic distributed runtime: the JAX package's ``distributed`` on the
port, over ``torch.distributed`` and the port's host runtime.

* ``MasterServer``/``MasterClient`` — task dispatch service over TCP
  whose state machine is the native C++ task queue (``native.py``);
  replaces go/master/service.go + etcd.
* ``CheckpointManager`` — CRC-verified, atomic, keep-last-N, optionally
  async checkpoints of scope state (``checkpoint.py``), and the sharded
  generations each rank writes its pieces of (``sharded_checkpoint.py``).
* ``RecoveryLoop`` / ``train_with_recovery`` — preemption and divergence
  recovery (the guard's rollback) and the elastic world change
  (``recovery.py``).
* ``membership.py`` (discovery, leases, election, the cluster epoch) and
  ``pserver.py`` (the runnable parameter server).
* save-model election (``request_save_model``) — exactly one trainer
  holds the save slot per window (go/master/service.go:481).

Every service speaks the line-JSON RPC of ``rpc.py``: a port client
talks to a JAX package server and the other way round.
"""

from paddle_tpu_torch.distributed.master import (  # noqa
    MasterServer, MasterClient,
)
from paddle_tpu_torch.distributed.checkpoint import (  # noqa
    CheckpointManager, save_checkpoint, load_checkpoint, latest_checkpoint,
)
from paddle_tpu_torch.distributed.rpc import (  # noqa
    RpcError, RpcConnectionError, RpcTimeout, RpcRemoteError,
    CircuitOpenError, CircuitBreaker, RpcChannel,
)
from paddle_tpu_torch.distributed.recovery import (  # noqa
    Preemption, RecoveryLoop, train_with_recovery,
)
from paddle_tpu_torch.parallel.distribute import init_multihost  # noqa
