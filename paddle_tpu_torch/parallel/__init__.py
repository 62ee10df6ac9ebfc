"""Parallelism over ``torch.distributed``: the mesh (the ``dp``, ``mp``,
``sp``, ``pp`` and ``ep`` axes), the gradient-communication layer with the tensor
axis's collectives, ``ParallelExecutor``, the distribute transpiler
(``distribute.init_multihost`` joins a process to its world), and, as
modules, ``context_parallel`` (ring attention), ``pipeline`` (the GPipe
and 1F1B schedules over 'pp'), ``expert_parallel`` (mixture of experts
over 'ep') and ``placement`` (the placement search)."""

from paddle_tpu_torch.parallel.mesh import get_mesh, make_mesh, mesh_guard  # noqa
from paddle_tpu_torch.parallel.parallel_executor import ParallelExecutor  # noqa
from paddle_tpu_torch.parallel.collectives import CommConfig  # noqa
from paddle_tpu_torch.parallel.distribute import DistributeTranspiler  # noqa
