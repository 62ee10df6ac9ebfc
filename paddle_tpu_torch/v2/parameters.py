"""v2 Parameters: numpy get/set + tar checkpoints.

Capability parity: `python/paddle/v2/parameters.py` (create, __getitem__/
__setitem__ as numpy, to_tar/from_tar). The tar layout is paddle_tpu's,
byte for byte: one ``<name>.bin`` member per parameter (raw bytes) plus a
``<name>.json`` member with dtype/shape — language-neutral like the
reference's ParameterHeader format, no pickle — so a checkpoint written
by either package loads in the other.
"""

import io
import json
import tarfile

import numpy as np
import torch

from paddle_tpu_torch.core import ir
from paddle_tpu_torch.core.executor import _to_numpy
from paddle_tpu_torch.core.scope import global_scope

__all__ = ["Parameters", "create"]


def create(*costs):
    """Runs the startup program (parameter init ops) on the v2 place and
    returns the Parameters view over the global scope."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.v2 import _place
    exe = fluid.Executor(_place())
    exe.run(ir.default_startup_program())
    prog = costs[0].block.program if costs else ir.default_main_program()
    names = [p.name for p in prog.global_block().all_parameters()]
    return Parameters(names)


class Parameters:
    def __init__(self, names=None, scope=None):
        self._names = list(names or [])
        self._scope = scope

    def _sc(self):
        return self._scope or global_scope()

    def names(self):
        return list(self._names)

    def keys(self):
        return self.names()

    def has_key(self, key):
        return key in self._names

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)

    def __getitem__(self, name):
        """A numpy copy of the value (a copy from the card, or of the CPU
        tensor: writing to it never reaches the scope)."""
        val = self._sc().find_var(name)
        if val is None:
            raise KeyError(name)
        return np.array(_to_numpy(val), copy=True)

    def __setitem__(self, name, value):
        """Writes a tensor on the variable's device in its dtype; a new
        name lands on the v2 place (``init``), float64 narrowed to
        float32 as paddle_tpu's ``jnp.asarray`` narrows it."""
        cur = self._sc().find_var(name)
        value = np.asarray(value)
        if cur is not None and tuple(cur.shape) != tuple(value.shape):
            raise ValueError("shape mismatch for %r: %s vs %s" %
                             (name, tuple(cur.shape), value.shape))
        if name not in self._names:
            self._names.append(name)
        if cur is not None:
            device, dtype = cur.device, cur.dtype
        else:
            from paddle_tpu_torch.v2 import _place
            device = _place().torch_device()
            dtype = torch.float32 if value.dtype == np.float64 else None
        self._sc().set_var(name, torch.as_tensor(
            np.ascontiguousarray(value)).to(device=device, dtype=dtype))

    def get(self, name):
        return self[name]

    def set(self, name, value):
        self[name] = value

    def get_shape(self, name):
        return tuple(self[name].shape)

    # ---- tar checkpoints ----

    def to_tar(self, f):
        with tarfile.open(fileobj=f, mode="w") as tar:
            for name in self._names:
                arr = self[name]
                meta = json.dumps({"dtype": arr.dtype.str,
                                   "shape": list(arr.shape)}).encode()
                for member, data in ((name + ".json", meta),
                                     (name + ".bin", arr.tobytes())):
                    info = tarfile.TarInfo(member)
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))

    @classmethod
    def from_tar(cls, f, scope=None):
        """Loads into a detached scope by default, on the v2 place —
        reading a checkpoint must not clobber the live model (pass
        scope=global_scope() or call init_from_tar to overwrite live
        weights)."""
        from paddle_tpu_torch.core.scope import Scope
        params = cls(scope=scope if scope is not None else Scope())
        with tarfile.open(fileobj=f, mode="r") as tar:
            metas, bins = {}, {}
            for member in tar.getmembers():
                data = tar.extractfile(member).read()
                if member.name.endswith(".json"):
                    metas[member.name[:-5]] = json.loads(data)
                elif member.name.endswith(".bin"):
                    bins[member.name[:-4]] = data
            for name, meta in metas.items():
                arr = np.frombuffer(
                    bins[name], dtype=np.dtype(meta["dtype"])).reshape(
                        meta["shape"]).copy()
                params[name] = arr
        return params

    def init_from_tar(self, f):
        """Overwrites THIS Parameters' values (live scope) from a tar."""
        other = Parameters.from_tar(f)
        for name in other.names():
            self[name] = other[name]
