"""Distributed runtime: the hardened line-JSON RPC channel.

The JAX package's ``distributed`` holds the elastic master, the
parameter server, membership, checkpoints and recovery on top of this
channel; the port has the channel (``rpc.py``), which its serving tier
runs on. The services above it arrive with later slices.
"""

from paddle_tpu_torch.distributed.rpc import (  # noqa: F401
    CircuitBreaker, CircuitOpenError, RpcChannel, RpcConnectionError,
    RpcError, RpcRemoteError, RpcTimeout)
