"""paddle_tpu_torch.v2 — the high-level trainer API.

Capability parity with the reference v2 stack (SURVEY §2.9:
python/paddle/v2): ``init``, composable ``layer``/``activation``/
``pooling`` namespaces, ``parameters`` with tar checkpoints,
``trainer.SGD(cost, parameters, update_equation).train(reader,
event_handler)``, ``event`` callbacks, ``inference.infer``. v2 layer calls
emit into the same Program IR as the fluid-style API (one IR, two
frontends), byte-identical to paddle_tpu's v2 programs, and run through
the same executor.

Where it runs: every executor v2 makes (``parameters.create``, the
trainer, ``infer``) runs on the place ``init`` chose. The default is the
card, ``CUDAPlace(0)``, with or without an ``init`` call, and it raises
where torch finds no card; ``init(use_gpu=False)`` asks for the CPU.
"""

from paddle_tpu_torch.v2 import activation  # noqa: F401
from paddle_tpu_torch.v2 import data_type  # noqa: F401
from paddle_tpu_torch.v2 import evaluator  # noqa: F401
from paddle_tpu_torch.v2 import event  # noqa: F401
from paddle_tpu_torch.v2 import inference  # noqa: F401
from paddle_tpu_torch.v2 import layer  # noqa: F401
from paddle_tpu_torch.v2 import networks  # noqa: F401
from paddle_tpu_torch.v2 import optimizer  # noqa: F401
from paddle_tpu_torch.v2 import parameters  # noqa: F401
from paddle_tpu_torch.v2 import pooling  # noqa: F401
from paddle_tpu_torch.v2 import trainer  # noqa: F401
from paddle_tpu_torch.v2.inference import infer  # noqa: F401

from paddle_tpu_torch import dataset  # noqa: F401
from paddle_tpu_torch import reader  # noqa: F401
from paddle_tpu_torch.reader.batch import batch  # noqa: F401

_settings = {"use_gpu": True, "trainer_count": 1, "initialized": False}


def init(use_gpu=True, trainer_count=1, **kwargs):
    """Reference `python/paddle/v2/__init__.py:127`. ``use_gpu`` picks the
    place of every executor v2 makes: ``CUDAPlace(0)`` (the default) or,
    with ``use_gpu=False``, ``CPUPlace()``. ``trainer_count > 1`` asks the
    trainer for data parallelism, which this package does not have yet:
    ``trainer.SGD`` then raises."""
    _settings.update(use_gpu=use_gpu, trainer_count=trainer_count,
                     initialized=True)
    _settings.update(kwargs)
    return _settings


def _place():
    """The place ``init`` chose: ``CUDAPlace(0)`` unless
    ``init(use_gpu=False)``."""
    from paddle_tpu_torch.core.place import CPUPlace, CUDAPlace

    return CUDAPlace(0) if _settings["use_gpu"] else CPUPlace()
