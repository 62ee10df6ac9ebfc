"""Parallelism over ``torch.distributed``: the mesh (the ``dp``, ``mp``
and ``sp`` axes), the gradient-communication layer with the tensor
axis's collectives, ``ParallelExecutor``, the distribute transpiler
(``distribute.init_multihost`` joins a process to its world), and, as
modules, ``context_parallel`` (ring attention) and ``placement`` (the
placement search). The pipeline and expert parallelism arrive with
later slices (ROADMAP.md Queue 1 items 4b and 4d)."""

from paddle_tpu_torch.parallel.mesh import get_mesh, make_mesh, mesh_guard  # noqa
from paddle_tpu_torch.parallel.parallel_executor import ParallelExecutor  # noqa
from paddle_tpu_torch.parallel.collectives import CommConfig  # noqa
from paddle_tpu_torch.parallel.distribute import DistributeTranspiler  # noqa
