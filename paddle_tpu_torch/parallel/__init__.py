"""Data parallelism over ``torch.distributed``: the ``dp`` mesh, the
gradient-communication layer, ``ParallelExecutor`` and the distribute
transpiler (``distribute.init_multihost`` joins a process to its
world). The tensor axis, the pipeline, context and expert parallelism
arrive with later slices."""

from paddle_tpu_torch.parallel.mesh import get_mesh, make_mesh, mesh_guard  # noqa
from paddle_tpu_torch.parallel.parallel_executor import ParallelExecutor  # noqa
from paddle_tpu_torch.parallel.collectives import CommConfig  # noqa
from paddle_tpu_torch.parallel.distribute import DistributeTranspiler  # noqa
