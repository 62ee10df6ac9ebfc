"""Serving: bucketed one-shot inference, dynamic batching, RPC, and
KV-cached autoregressive decoding.

* ``engine``  — ``ServingEngine``: one captured CUDA graph per batch
  bucket, built before ready, in a cache the recompile detector watches.
* ``batcher`` — ``DynamicBatcher``: deadline-aware micro-batching with
  bounded-queue admission control (``Overloaded`` load shedding).
* ``server``  — ``ServingServer`` / ``ServingClient``: the line-JSON
  RPC front-end (``infer``, ``generate``) with health/readiness and
  graceful drain.
* ``kv_cache`` / ``decode`` — ``DecodeEngine`` (a prefill ladder + ONE
  decode step, each a CUDA graph on the card) and ``DecodeLoop``
  (continuous batching).

The JAX package's router, replica launcher and persistent AOT cache
arrive with later slices.
"""

from paddle_tpu_torch.serving.engine import (  # noqa: F401
    BatchTooLarge, NotReady, ServingEngine, default_buckets)
from paddle_tpu_torch.serving.batcher import (  # noqa: F401
    Closed, DeadlineExceeded, DynamicBatcher, Overloaded)
from paddle_tpu_torch.serving.server import (  # noqa: F401
    ServingClient, ServingServer)
from paddle_tpu_torch.serving.kv_cache import (  # noqa: F401
    KVCache, SlotAllocator)
from paddle_tpu_torch.serving.decode import (  # noqa: F401
    DecodeEngine, DecodeLoop, Generation)

__all__ = ["ServingEngine", "DynamicBatcher", "ServingServer",
           "ServingClient",
           "DecodeEngine", "DecodeLoop", "Generation",
           "KVCache", "SlotAllocator",
           "Overloaded", "Closed", "DeadlineExceeded",
           "NotReady", "BatchTooLarge", "default_buckets"]
