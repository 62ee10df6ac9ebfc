"""Slot-based KV-cache runtime state for autoregressive decode serving.

The decode tier's working set is a fixed array of *slots*: per layer,
one ``[num_slots, heads, max_len, head_dim]`` K buffer and one V
buffer, plus a per-slot write position. A generation claims a slot at
admission, its prompt's K/V is prefilled into that row, every decode
step appends one position, and the slot returns to the free list the
moment the generation terminates — BETWEEN token steps, so a new
request never waits behind an unrelated long generation (continuous
batching).

Shapes never change: the slot count, cache length, and buffer dtype
(float32, or bfloat16: half the bytes; the decode kernel reads either)
are fixed at construction, and claiming and releasing slots is pure
host bookkeeping (a free list and an active mask). The buffers live on
the engine's device and every prefill/decode call updates them in
place (where the JAX package donates them through each call).

Free-slot rows still flow through the decode math (the array is always
full-width) — they compute on token 0 at position 0 and write finite
garbage their length mask never reads.
"""

import threading

import numpy as np
import torch

from paddle_tpu_torch.core.infer import torch_dtype
from paddle_tpu_torch.core.place import default_place

__all__ = ["SlotAllocator", "KVCache", "cache_dtype"]


def cache_dtype(dtype):
    """A cache dtype (a name, as the JAX package takes it, or a torch
    dtype) as a torch dtype."""
    return dtype if isinstance(dtype, torch.dtype) \
        else torch_dtype(str(dtype))


class SlotAllocator:
    """Free-list + active mask over ``num_slots`` slots. Thread-safe:
    the scheduler claims/releases between steps, probes read occupancy
    concurrently."""

    def __init__(self, num_slots):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1, got %d" % num_slots)
        self.num_slots = int(num_slots)
        self._lock = threading.Lock()
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._active = np.zeros(self.num_slots, dtype=bool)

    def claim(self):
        """Lowest free slot index, or None when full."""
        with self._lock:
            if not self._free:
                return None
            s = self._free.pop()
            self._active[s] = True
            return s

    def release(self, slot):
        with self._lock:
            if not self._active[slot]:
                raise ValueError("slot %d released twice (or never "
                                 "claimed)" % slot)
            self._active[slot] = False
            self._free.append(slot)
            self._free.sort(reverse=True)

    def active_slots(self):
        with self._lock:
            return [i for i in range(self.num_slots) if self._active[i]]

    def active_count(self):
        with self._lock:
            return int(self._active.sum())

    def occupancy(self):
        with self._lock:
            return float(self._active.sum()) / self.num_slots

    def reset(self):
        with self._lock:
            self._free = list(range(self.num_slots - 1, -1, -1))
            self._active[:] = False


class KVCache:
    """The device-resident cache buffers + host-side positions.

    ``buffers`` maps each cache feed name (``kv_l<i>_{k,v}``, from the
    model's ``DecodeModelMeta``) to its tensor on ``device``; ``pos`` is
    the host-side per-slot write position (``pos[s]`` = how many cache
    entries slot ``s`` has filled = the position its NEXT token writes).
    Only the decode loop thread mutates either. ``dtype`` (a name or a
    torch dtype) is the buffers' dtype; ``nbytes()`` follows it.
    ``device`` (a torch device or a place) defaults to ``CUDAPlace(0)``,
    which raises when there is no card."""

    def __init__(self, meta, num_slots, dtype="float32", device=None):
        self.meta = meta
        self.num_slots = int(num_slots)
        self.device = torch.device(device) if isinstance(
            device, (torch.device, str)) else default_place(device)
        self.dtype = cache_dtype(dtype)
        self.shape = (self.num_slots, meta.num_heads, meta.max_len,
                      meta.head_dim)
        self.buffers = {}
        self.pos = np.zeros(self.num_slots, np.int32)
        self.reset()

    def nbytes(self):
        return sum(b.numel() * b.element_size()
                   for b in self.buffers.values())

    def reset(self):
        """Zero everything (engine-failure recovery), in place: a CUDA
        graph of the engine that reads these buffers keeps reading them."""
        if self.buffers:
            for b in self.buffers.values():
                b.zero_()
        else:
            self.buffers = {n: torch.zeros(self.shape, dtype=self.dtype,
                                           device=self.device)
                            for n in self.meta.cache_names}
        self.pos[:] = 0
