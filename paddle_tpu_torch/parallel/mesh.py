"""The data-parallel mesh over a ``torch.distributed`` process group.

Capability parity: the JAX package's ``parallel/mesh.py`` (a
``jax.sharding.Mesh`` over the devices) and the reference's NCCL context
map (`platform/nccl_helper.h:72`). The port runs one process a rank, as
PyTorch's DDP does: a :class:`Mesh` names its axes and their sizes and
holds the ranks of the process group it spans. Only the ``dp`` axis is
ported: a mesh with another axis (``mp``, ``pp``, ``sp``, ``ep``) raises
``NotImplementedError`` until the tensor-axis slice brings it.

The sharding helpers return :class:`Sharding` descriptors (a mesh and a
per-dimension spec, the shape of a ``NamedSharding``), which
``ParallelExecutor.state_shardings`` reports. They place nothing: the
executor cuts every batch-leading feed by rows and keeps 1/N of each
ZeRO accumulator's flat elements on a rank (``collectives``).
"""

import contextlib

import torch.distributed as dist

__all__ = ["make_mesh", "get_mesh", "mesh_guard", "data_sharding",
           "param_sharding", "zero_sharding", "chunk_sharding",
           "replicated", "Mesh", "Sharding", "P"]

_current_mesh = None

# the tensor-axis work that brings the other mesh axes (ROADMAP.md)
_LATER = ("mesh axes other than 'dp' arrive with the tensor axis, the "
          "pipeline, context and expert parallelism (ROADMAP.md Queue 1 "
          "item 4, its tensor-axis bullet)")


def P(*spec):
    """A partition spec: one mesh axis name (or None) per dimension."""
    return tuple(spec)


class Mesh:
    """Axis names, their sizes (``shape``, in axis order) and the global
    ranks the mesh spans, in mesh order. ``group`` is the process group
    of those ranks (None: the default group, when the mesh spans the
    whole world)."""

    def __init__(self, axis_names, shape, ranks, group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.ranks = tuple(int(r) for r in ranks)
        self.group = group

    @property
    def size(self):
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def rank(self):
        """This process's index on the mesh (its rank in ``group``)."""
        return self.ranks.index(dist.get_rank())

    def __eq__(self, other):
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.shape == other.shape and self.ranks == other.ranks)

    def __hash__(self):
        return hash((self.axis_names, tuple(self.shape.values()),
                     self.ranks))

    def __repr__(self):
        return "Mesh(%s, ranks=%s)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()),
            list(self.ranks))


class Sharding:
    """A mesh and a partition spec (the port's ``NamedSharding``)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __eq__(self, other):
        return (isinstance(other, Sharding) and self.mesh == other.mesh
                and self.spec == other.spec)

    def __hash__(self):
        return hash((self.mesh, self.spec))

    def __repr__(self):
        return "Sharding(%r, P%r)" % (self.mesh, self.spec)


def _world():
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group, one "
            "process a rank: call paddle_tpu_torch.parallel.distribute."
            "init_multihost(...) in every process first (or "
            "torch.distributed.init_process_group)")
    return dist.get_world_size()


def make_mesh(mesh_shape=None, axis_names=None, devices=None):
    """Build a Mesh. Default: every rank of the world on one 'dp' axis.
    ``devices``: the global ranks to span (default: the world's, in
    order); a mesh smaller than them takes the first ``n``, as the JAX
    package takes ``devices[:n]``, in a process group of its own."""
    world = _world()
    ranks = list(devices) if devices is not None else list(range(world))
    if mesh_shape is None:
        mesh_shape = (len(ranks),)
        axis_names = axis_names or ("dp",)
    axis_names = axis_names or tuple("dp mp pp sp ep".split()[
        : len(mesh_shape)])
    if tuple(axis_names) != ("dp",):
        raise NotImplementedError(
            "make_mesh%s over axes %r: %s" % (
                (tuple(mesh_shape),), tuple(axis_names), _LATER))
    n = 1
    for s in mesh_shape:
        n *= int(s)
    if n > len(ranks):
        raise ValueError("mesh %s needs %d devices, have %d"
                         % (tuple(mesh_shape), n, len(ranks)))
    ranks = ranks[:n]
    group = None
    if ranks != list(range(world)):
        # every rank of the world takes part in making a group
        group = dist.new_group(ranks)
    return Mesh(axis_names, mesh_shape, ranks, group)


def get_mesh():
    return _current_mesh


@contextlib.contextmanager
def mesh_guard(mesh):
    global _current_mesh
    prev = _current_mesh
    _current_mesh = mesh
    try:
        yield mesh
    finally:
        _current_mesh = prev


def data_sharding(mesh, var=None, batch_axis="dp", seq_axis=None):
    """Batch-dim sharding spec for a feed; a sequence axis is refused
    until context parallelism is ported."""
    if batch_axis not in mesh.axis_names:
        return Sharding(mesh, P())
    if seq_axis and seq_axis in mesh.axis_names:
        raise NotImplementedError("data_sharding over %r: %s"
                                  % (seq_axis, _LATER))
    return Sharding(mesh, P(batch_axis))


def param_sharding(mesh, var):
    """A parameter's spec from ``Variable.sharding`` (axes this mesh
    lacks dropped), else replicated."""
    spec = getattr(var, "sharding", None) if var is not None else None
    if spec:
        return Sharding(mesh, P(*(a if (a is None or a in mesh.axis_names)
                                  else None for a in spec)))
    return Sharding(mesh, P())


def zero_sharding(mesh, var, param_var=None, axis="dp"):
    """ZeRO-1 optimizer-state sharding: the accumulator's first free
    dimension divisible by the axis size goes over ``axis``, layered
    onto its parameter's own spec (the JAX package's rule, kept so
    ``state_shardings`` reads alike). The executor itself keeps 1/N of
    the FLAT accumulator on a rank (``collectives``), whatever spec this
    names: a spec that shards no dimension (the beta-pow scalars) means
    a replicated value."""
    if var is None or axis not in mesh.axis_names or not var.shape:
        return param_sharding(mesh, var)
    base = list(getattr(param_var, "sharding", None) or ())
    spec = [base[i] if i < len(base) else None for i in range(len(var.shape))]
    spec = [a if (a is not None and a in mesh.axis_names
                  and var.shape[i] % mesh.shape[a] == 0
                  and var.shape[i] >= mesh.shape[a]) else None
            for i, a in enumerate(spec)]
    if axis not in spec:
        n = mesh.shape[axis]
        for i, d in enumerate(var.shape):
            if spec[i] is None and d >= n and d % n == 0:
                spec[i] = axis
                break
    return Sharding(mesh, P(*spec))


def chunk_sharding(sharding):
    """A per-step feed spec lifted to its ``[K, ...]`` super-batch form:
    the leading K axis is replicated, the spec shifts one axis right."""
    return Sharding(sharding.mesh, P(None, *sharding.spec))


def replicated(mesh):
    return Sharding(mesh, P())
