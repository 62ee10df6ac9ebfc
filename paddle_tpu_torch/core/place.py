"""Places: where a program executes.

Capability parity: `paddle/fluid/platform/place.h` (CPUPlace / CUDAPlace).
A place names one torch device. ``CUDAPlace`` is the default of every
entry point of this package; ``CPUPlace`` is asked for explicitly (the
tests do) and runs each kernel's plain PyTorch version.
"""

import torch

__all__ = ["CPUPlace", "CUDAPlace", "default_place",
           "is_compiled_with_cuda", "is_compiled_with_tpu"]


class Place:
    def torch_device(self):
        raise NotImplementedError

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, getattr(self, "device_id", 0))

    def __eq__(self, other):
        return (type(self) is type(other)
                and getattr(self, "device_id", 0) == getattr(other, "device_id", 0))

    def __hash__(self):
        return hash((type(self).__name__, getattr(self, "device_id", 0)))


class CPUPlace(Place):
    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDAPlace(%d): no CUDA device is available. Pass "
                "CPUPlace() explicitly to run on the CPU." % self.device_id)
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError("CUDAPlace(%d): only %d CUDA devices"
                               % (self.device_id, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)


def default_place(place):
    """Resolve an entry point's ``place`` argument to a torch device:
    None means ``CUDAPlace(0)``, which raises when there is no card."""
    return (place if place is not None else CUDAPlace(0)).torch_device()


def is_compiled_with_cuda():
    """True when torch sees a CUDA device (reference
    `fluid.core.is_compiled_with_cuda`)."""
    return torch.cuda.is_available()


def is_compiled_with_tpu():
    """Always False: the port runs on CUDA and the CPU only (the
    reference's TPU build flag; the JAX package answers for its
    backend)."""
    return False
