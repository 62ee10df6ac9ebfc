"""The device mesh over a ``torch.distributed`` process group.

Capability parity: the JAX package's ``parallel/mesh.py`` (a
``jax.sharding.Mesh`` over the devices) and the reference's NCCL context
map (`platform/nccl_helper.h:72`). The port runs one process a rank, as
PyTorch's DDP does: a :class:`Mesh` names its axes and their sizes and
holds the ranks of the process group it spans, in the JAX package's
row-major device order (axis k's stride is the product of the later
axes' sizes). Named axes:

  dp — data parallel          (batch rows; the gradient exchange)
  mp — model/tensor parallel  (weight shards; ``collectives``' Megatron
                               all-reduces)
  sp — sequence/context parallel (time chunks; ring attention,
                               ``context_parallel``)
  pp — pipeline parallel      (one stage a rank; point-to-point sends
                               between neighbours, ``pipeline``)
  ep — expert parallel        (E/ep experts a rank, ``expert_parallel``)

``make_mesh`` makes one process group for each line of each axis (the
ranks that differ only in that axis' coordinate): a rank's collectives
over an axis run in its line's group (:meth:`Mesh.axis_group`), and a
stage's sends go to its neighbours on its pp line.

The sharding helpers return :class:`Sharding` descriptors (a mesh and a
per-dimension spec, the shape of a ``NamedSharding``), which
``ParallelExecutor.state_shardings`` reports. They place nothing: the
executor cuts every batch-leading feed by rows (and by time over a
sequence axis), slices each 'mp'-sharded parameter to this rank's shard
for a step, keeps 1/N of each ZeRO accumulator's flat elements on a
rank, and holds each 'pp'- or 'ep'-cut parameter (and its accumulators)
as this rank's leading-dim slice (``collectives``).
"""

import contextlib

import torch.distributed as dist

__all__ = ["make_mesh", "get_mesh", "mesh_guard", "data_sharding",
           "param_sharding", "zero_sharding", "chunk_sharding",
           "replicated", "Mesh", "Sharding", "P"]

_current_mesh = None

#: the axes a mesh may have
_AXES = ("dp", "mp", "sp", "pp", "ep")

# the group of a line that spans the whole world: torch.distributed's
# default group
_WORLD = None


def P(*spec):
    """A partition spec: one mesh axis name (or None) per dimension."""
    return tuple(spec)


class Mesh:
    """Axis names, their sizes (``shape``, in axis order) and the global
    ranks the mesh spans, in mesh order (row-major over the axes).
    ``group`` is the process group of those ranks (None: the default
    group, when the mesh spans the whole world); ``axis_groups``
    {axis: the group of this rank's line along it}, which ``make_mesh``
    fills (a mesh made by hand has none, and its lines must then be the
    whole mesh)."""

    def __init__(self, axis_names, shape, ranks, group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.ranks = tuple(int(r) for r in ranks)
        self.group = group
        self.axis_groups = {}

    @property
    def size(self):
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def rank(self):
        """This process's index on the mesh (its rank in ``group``)."""
        return self.ranks.index(dist.get_rank())

    def coords(self, index=None):
        """{axis: coordinate} of mesh index ``index`` (default: this
        process's), row-major as the JAX package lays devices out."""
        index = self.rank() if index is None else int(index)
        out = {}
        for a in reversed(self.axis_names):
            out[a] = index % self.shape[a]
            index //= self.shape[a]
        return out

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    def axis_rank(self, axis):
        """This process's coordinate along ``axis`` (0 where the mesh
        lacks it)."""
        return self.coords()[axis] if axis in self.shape else 0

    def line(self, axis, index=None):
        """The global ranks of the line along ``axis`` through mesh index
        ``index`` (default: this process's), in axis order."""
        index = self.rank() if index is None else int(index)
        c = self.coords(index)
        stride = 1
        for a in reversed(self.axis_names):
            if a == axis:
                break
            stride *= self.shape[a]
        base = index - c[axis] * stride
        return [self.ranks[base + i * stride]
                for i in range(self.shape[axis])]

    def axis_group(self, axis):
        """The process group of this rank's line along ``axis``."""
        if axis in self.axis_groups:
            return self.axis_groups[axis]
        if self.shape.get(axis) == self.size:
            return self.group
        raise ValueError("mesh %r has no process group for its %r lines "
                         "(make it with make_mesh)" % (self, axis))

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


def _group_of(ranks, world, mesh_ranks, mesh_group):
    """The process group of ``ranks``: the default group for the whole
    world, the mesh's own for the whole mesh, else a new one (which
    every rank of the world takes part in making)."""
    if list(ranks) == list(range(world)):
        return _WORLD
    if list(ranks) == list(mesh_ranks):
        return mesh_group
    return dist.new_group(list(ranks))


def make_mesh(mesh_shape=None, axis_names=None, devices=None):
    """Build a Mesh. Default: every rank of the world on one 'dp' axis.
    ``devices``: the global ranks to span (default: the world's, in
    order); a mesh smaller than them takes the first ``n``, as the JAX
    package takes ``devices[:n]``, in a process group of its own. Every
    rank of the world must call it (each group is made by all of them),
    also one that the mesh leaves out."""
    if mesh_shape is not None:
        axis_names = tuple(axis_names or tuple("dp mp pp sp ep".split()[
            : len(mesh_shape)]))
    for a in axis_names or ():
        if a not in _AXES or axis_names.count(a) > 1:
            raise ValueError("make_mesh: axes must be distinct names of "
                             "%r, got %r" % (_AXES, axis_names))
    world = _world()
    ranks = list(devices) if devices is not None else list(range(world))
    if mesh_shape is None:
        mesh_shape = (len(ranks),)
        axis_names = tuple(axis_names or ("dp",))
    if len(axis_names) != len(mesh_shape):
        raise ValueError("make_mesh: %d axis names for a %d-d shape %r"
                         % (len(axis_names), len(mesh_shape),
                            tuple(mesh_shape)))
    n = 1
    for s in mesh_shape:
        n *= int(s)
    if n > len(ranks):
        raise ValueError("mesh %s needs %d devices, have %d"
                         % (tuple(mesh_shape), n, len(ranks)))
    ranks = ranks[:n]
    group = _WORLD if ranks == list(range(world)) \
        else dist.new_group(ranks)
    mesh = Mesh(axis_names, mesh_shape, ranks, group)
    me = dist.get_rank()
    # one group a line of each axis, made in the same order everywhere
    for a in axis_names:
        seen = set()
        for i in range(n):
            line = tuple(mesh.line(a, i))
            if line in seen:
                continue
            seen.add(line)
            g = _group_of(line, world, ranks, group)
            if me in line:
                mesh.axis_groups[a] = g
    return mesh


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
    """Batch-dim sharding spec for a feed; optionally shard the time axis
    too (sequence parallelism): ``ParallelExecutor`` then cuts each
    batch-leading feed by rows over ``batch_axis`` and by time (its
    dimension 1) over ``seq_axis``."""
    if batch_axis not in mesh.axis_names:
        return Sharding(mesh, P())
    if seq_axis and seq_axis in mesh.axis_names:
        return Sharding(mesh, P(batch_axis, seq_axis))
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
