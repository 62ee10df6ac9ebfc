"""Pipeline parallelism over the 'pp' mesh axis: the GPipe and 1F1B
schedules, one process a stage.

Capability parity: the JAX package's ``parallel/pipeline.py`` (the
reference era had no pipeline; its relative is the per-layer device
placement of `gserver/gradientmachines/ParallelNeuralNetwork.h:34`).
The JAX package runs the schedule inside one ``shard_map`` as a
``lax.scan`` whose ticks are all alike (systolic feed and drain FIFOs);
the port runs one process a rank, as PyTorch's pipelines do: each rank
runs its own stage in a plain loop over ticks, and the boundary
activations (forward) and their cotangents (backward) go to the
neighbouring stages by point-to-point sends over the rank's pp line
(``dist.batch_isend_irecv``, one batch a tick). The same tick loop runs
all S stages in one process (:func:`pipeline_in_process`, ranks
``None``), where a send is a hand-over: one card holds one NCCL rank,
so that is how the schedules run there at S > 1.

Tick ``t`` runs microbatch ``t - st`` forward at stage ``st``; a value
made at tick ``t`` is received at tick ``t + 1``.

* **GPipe** (:func:`pipeline_parallel_stacked`): all M forwards, then
  the M backwards, microbatch 0 first, each stage at tick ``m + S - 1 -
  st``. The forward keeps each microbatch's autograd graph (no
  recompute), as JAX's autodiff of the scan keeps its residuals.
* **1F1B** (:func:`pipeline_1f1b`): the forward is the GPipe forward
  without graphs (its bits); the backward replays it interleaved with
  the backward, stage ``st`` running microbatch ``t - st`` forward and
  microbatch ``t - 2(S-1) + st`` backward at tick ``t``, the latter by
  recomputing the stage forward from its stashed input under
  ``torch.enable_grad``. Stage ``st`` holds at most ``2(S-1-st)+1``
  stashed inputs (``fn.peak``, ``stats["peak"]``), the 1F1B bound,
  instead of M.
* **Accumulation order**: both schedules add the per-microbatch
  gradient contributions of a stage microbatch-major (``((d_0 + d_1) +
  d_2) ...``) and sum the consts' over the stages in stage order, so
  their gradients are bitwise equal.

Row layout: microbatch ``m`` of the plain functions holds global rows
``[m·B/M, (m+1)·B/M)`` and ``batch_axis`` cuts within each microbatch,
as the JAX package's in_specs ``P(axis, batch_axis)``. Under
``ParallelExecutor`` the feed is already cut to the rank's rows over
'dp', and microbatch ``m`` holds ``[m·b/M, (m+1)·b/M)`` of those: each
rank's microbatches hold other global rows than the JAX package's, so
the two agree where the stage body treats rows independently (every
body of this repository), with the sums in another order.

The boundary activation has one dtype at every stage and in the
point-to-point buffers: the input's (a stage output of another dtype,
an AMP body's bfloat16, is cast to it).
"""

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from paddle_tpu_torch.parallel.collectives import gather_line, sum_line

__all__ = ["pipeline_parallel", "pipeline_parallel_stacked",
           "pipeline_1f1b", "split_microbatches", "join_microbatches",
           "pipeline_in_process"]


def split_microbatches(x, num_micro):
    """[B, ...] -> [M, B/M, ...]."""
    b = x.shape[0]
    assert b % num_micro == 0, (b, num_micro)
    return x.reshape((num_micro, b // num_micro) + tuple(x.shape[1:]))


def join_microbatches(y):
    return y.reshape((-1,) + tuple(y.shape[2:]))


def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


class _Line:
    """The stages this process runs and how boundary tensors reach the
    neighbouring stages: all ``num_stages`` in this process (``ranks``
    None: a send is a hand-over), or stage ``stage`` of a pp line whose
    global ranks are ``ranks`` (point-to-point sends in ``group``).
    ``comm``: the step's ``collectives.TraceComm``, whose census records
    every send and collective."""

    def __init__(self, num_stages, stage=None, ranks=None, group=None,
                 comm=None, axis="pp"):
        self.num_stages = int(num_stages)
        self.ranks = None if ranks is None else [int(r) for r in ranks]
        self.stages = list(range(self.num_stages)) if ranks is None \
            else [int(stage)]
        self.group = group
        self.comm = comm
        self.axis = axis
        #: stage -> the most stage inputs the 1F1B backward held at once
        self.peak = {}

    @property
    def distributed(self):
        return self.ranks is not None and self.num_stages > 1

    def _refuse_capture(self, what):
        if _capturing():
            raise RuntimeError(
                "pipeline: a CUDA graph cannot capture the %s between "
                "pipeline stages; run the step eagerly (Executor.run), or "
                "at one stage" % what)

    def _census(self):
        return self.comm.note_collective if self.comm is not None else None

    def _note(self, kind, t, tag, wire=None):
        if self.comm is not None:
            self.comm.note_collective(
                kind, t, t.element_size() * t.numel() if wire is None
                else wire, tag, self.axis)

    def exchange(self, outbox, wants):
        """Deliver the values of ``outbox`` ({(src stage, dst stage,
        kind): tensor}, made at the tick before) and return the ones
        this process's stages want this tick ({key: (shape, dtype,
        device)})."""
        if not self.distributed:
            got = {k: outbox.pop(k) for k in wants}
            assert not outbox, sorted(outbox)
            return got
        ops, got, keep = [], {}, []
        for (src, dst, kind), t in outbox.items():
            t = t.contiguous()
            keep.append(t)
            ops.append(dist.P2POp(dist.isend, t, self.ranks[dst],
                                  self.group))
            self._note("send_recv", t, "pp." + kind)
        for key, (shape, dtype, device) in wants.items():
            buf = torch.empty(shape, dtype=dtype, device=device)
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[key[0]],
                                  self.group))
            got[key] = buf
        if ops:
            self._refuse_capture("point-to-point sends")
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        outbox.clear()
        return got

    def broadcast(self, t, src_stage, shape, dtype, device, tag):
        """Stage ``src_stage``'s ``t`` on every stage of the line."""
        if not self.distributed:
            return t
        self._refuse_capture("broadcasts")
        buf = t.contiguous() if self.stages[0] == src_stage \
            else torch.empty(shape, dtype=dtype, device=device)
        dist.broadcast(buf, self.ranks[src_stage], group=self.group)
        self._note("broadcast", buf, "pp." + tag)
        return buf

    def sum_over(self, t, group, world, tag, axis):
        """The sum of ``t`` over the ``world`` ranks of ``group``, in rank
        order (the same bits on every rank)."""
        if world == 1:
            return t
        self._refuse_capture("cross-rank sums")
        return sum_line(t, group, world, self._census(), tag, axis)


class _Engine:
    """One pipeline call's schedule: ``call(st, params, consts, act)``
    runs stage ``st`` on its parameter list and the const list;
    ``slices(params)`` gives {stage: its parameter tensors} of the
    Function's parameter inputs and ``assemble`` maps the stages'
    gradients back onto them; ``batch``: (group, world, axis) of the
    plain functions' sum over the batch axis, or None."""

    def __init__(self, line, call, slices, assemble, schedule="gpipe",
                 batch=None):
        self.line = line
        self.call = call
        self.slices = slices
        self.assemble = assemble
        self.schedule = schedule
        self.batch = batch

    def stage(self, st, params, consts, act):
        out = self.call(st, params, consts, act)
        return out if out.dtype == act.dtype else out.to(act.dtype)


def _forward(eng, x_mb, params, consts, keep=False):
    """The GPipe forward ticks: ({m: last stage's output} where this
    process runs the last stage, {(st, m): (input leaf, output)} of the
    kept graphs)."""
    line = eng.line
    s, m_total = line.num_stages, x_mb.shape[0]
    spec = (tuple(x_mb.shape[1:]), x_mb.dtype, x_mb.device)
    outs, graphs, outbox = {}, {}, {}
    for t in range(m_total + s - 1):
        wants = {(st - 1, st, "act"): spec for st in line.stages
                 if st > 0 and 0 <= t - st < m_total}
        inbox = line.exchange(outbox, wants)
        for st in line.stages:
            m = t - st
            if not 0 <= m < m_total:
                continue
            inp = x_mb[m] if st == 0 else inbox[(st - 1, st, "act")]
            if keep:
                leaf = inp.detach().requires_grad_()
                with torch.enable_grad():
                    out = eng.stage(st, params[st], consts, leaf)
                graphs[(st, m)] = (leaf, out)
                out = out.detach()
            else:
                out = eng.stage(st, params[st], consts, inp)
            if st < s - 1:
                outbox[(st, st + 1, "act")] = out
            else:
                outs[m] = out
    return outs, graphs


def _gather_out(eng, outs, x_mb):
    """[M, b, ...]: the last stage's outputs on every stage of the line."""
    line = eng.line
    s = line.num_stages
    y = torch.stack([outs[m] for m in range(x_mb.shape[0])]) \
        if (s - 1) in line.stages else None
    return line.broadcast(y, s - 1, tuple(x_mb.shape), x_mb.dtype,
                          x_mb.device, "out")


def _accumulate(acc, gs):
    """Add one microbatch's gradients onto ``acc`` (microbatch-major)."""
    for i, g in enumerate(gs):
        if g is None:
            continue
        acc[i] = g if acc[i] is None else acc[i] + g


def _grad(out, leaf, leaves, cot):
    ins = [leaf] + [t for t in leaves if t.requires_grad]
    gs = torch.autograd.grad(out, ins, cot.to(out.dtype), allow_unused=True)
    it = iter(gs[1:])
    return gs[0], [next(it) if t.requires_grad else None for t in leaves]


def _gpipe_backward(eng, graphs, leaves, dy_mb):
    """The GPipe backward ticks over the kept graphs: ({m: dx} where this
    process runs stage 0, {st: [per-leaf gradient]})."""
    line = eng.line
    s, m_total = line.num_stages, dy_mb.shape[0]
    spec = (tuple(dy_mb.shape[1:]), dy_mb.dtype, dy_mb.device)
    acc = {st: [None] * len(leaves[st]) for st in line.stages}
    dx, outbox = {}, {}
    for t in range(m_total + s - 1):
        wants = {(st + 1, st, "cot"): spec for st in line.stages
                 if st < s - 1 and 0 <= t - (s - 1 - st) < m_total}
        inbox = line.exchange(outbox, wants)
        for st in line.stages:
            m = t - (s - 1 - st)
            if not 0 <= m < m_total:
                continue
            cot = dy_mb[m] if st == s - 1 else inbox[(st + 1, st, "cot")]
            leaf, out = graphs.pop((st, m))
            d_in, gs = _grad(out, leaf, leaves[st], cot)
            _accumulate(acc[st], gs)
            d_in = torch.zeros_like(leaf) if d_in is None else d_in
            if st > 0:
                outbox[(st, st - 1, "cot")] = d_in.to(dy_mb.dtype)
            else:
                dx[m] = d_in
    return dx, acc


def _1f1b_backward(eng, x_mb, params, consts, leaves, n_params, dy_mb):
    """The 1F1B backward ticks: the forward replayed (``params``,
    ``consts``), interleaved with the backward of the stashed inputs'
    recomputed stages (``leaves``: {stage: its ``n_params`` parameter
    leaves, then the consts' leaves})."""
    line = eng.line
    s, m_total = line.num_stages, x_mb.shape[0]
    spec = (tuple(x_mb.shape[1:]), x_mb.dtype, x_mb.device)
    acc = {st: [None] * len(leaves[st]) for st in line.stages}
    stash = {st: {} for st in line.stages}
    dx, outbox = {}, {}
    for t in range(m_total + 2 * (s - 1)):
        wants = {}
        for st in line.stages:
            if st > 0 and 0 <= t - st < m_total:
                wants[(st - 1, st, "act")] = spec
            if st < s - 1 and 0 <= t - 2 * (s - 1) + st < m_total:
                wants[(st + 1, st, "cot")] = spec
        inbox = line.exchange(outbox, wants)
        for st in line.stages:
            mf = t - st
            if 0 <= mf < m_total:
                inp = x_mb[mf] if st == 0 else inbox[(st - 1, st, "act")]
                stash[st][mf] = inp
                line.peak[st] = max(line.peak.get(st, 0), len(stash[st]))
                if st < s - 1:
                    outbox[(st, st + 1, "act")] = eng.stage(
                        st, params[st], consts, inp)
            mb = t - 2 * (s - 1) + st
            if 0 <= mb < m_total:
                cot = dy_mb[mb] if st == s - 1 \
                    else inbox[(st + 1, st, "cot")]
                leaf = stash[st].pop(mb).detach().requires_grad_()
                with torch.enable_grad():
                    out = eng.stage(st, leaves[st][:n_params],
                                    leaves[st][n_params:], leaf)
                d_in, gs = _grad(out, leaf, leaves[st], cot)
                _accumulate(acc[st], gs)
                d_in = torch.zeros_like(leaf) if d_in is None else d_in
                if st > 0:
                    outbox[(st, st - 1, "cot")] = d_in.to(dy_mb.dtype)
                else:
                    dx[mb] = d_in
    return dx, acc


def _leaf(t):
    return t.detach().requires_grad_() if t.is_floating_point() \
        else t.detach()


class _PipelineFn(torch.autograd.Function):
    """The schedule as one autograd node: forward the GPipe forward,
    backward the schedule's backward (``eng.schedule``). Inputs: the
    engine, the microbatched input ``[M, b, ...]``, the number of
    parameter tensors, then the parameter tensors and the consts."""

    @staticmethod
    def forward(ctx, eng, x_mb, n_params, *tensors):
        params_in, consts = tensors[:n_params], tensors[n_params:]
        per = eng.slices(params_in)
        if eng.schedule == "gpipe":
            cl = [_leaf(c) for c in consts]
            leaves = {st: [_leaf(p) for p in per[st]] + cl for st in per}
            pleaves = {st: leaves[st][:n_params] for st in per}
            outs, graphs = _forward(eng, x_mb, pleaves, cl, keep=True)
            ctx.graphs, ctx.leaves = graphs, leaves
        else:
            outs, _ = _forward(eng, x_mb, per, list(consts))
            ctx.save_for_backward(x_mb, *tensors)
        ctx.eng = eng
        ctx.shapes = [(tuple(t.shape), t.dtype, t.is_floating_point())
                      for t in tensors]
        ctx.n_params = n_params
        return _gather_out(eng, outs, x_mb)

    @staticmethod
    def backward(ctx, dy_mb):
        eng, n = ctx.eng, ctx.n_params
        line = eng.line
        dy_mb = dy_mb.contiguous()
        if eng.schedule == "gpipe":
            dx, acc = _gpipe_backward(eng, ctx.graphs, ctx.leaves, dy_mb)
            ctx.graphs = ctx.leaves = None
        else:
            x_mb, *tensors = ctx.saved_tensors
            per = eng.slices(tensors[:n])
            consts = list(tensors[n:])
            cl = [_leaf(c) for c in consts]
            leaves = {st: [_leaf(p) for p in per[st]] + cl for st in per}
            dx, acc = _1f1b_backward(eng, x_mb, per, consts, leaves, n,
                                     dy_mb)
        m_total = dy_mb.shape[0]
        dx_mb = torch.stack([dx[m] for m in range(m_total)]) \
            if 0 in line.stages else None
        dx_mb = line.broadcast(dx_mb, 0, tuple(dy_mb.shape), dy_mb.dtype,
                               dy_mb.device, "dx")
        dparams = eng.assemble({st: a[:n] for st, a in acc.items()},
                               ctx.shapes[:n])
        # the consts' gradients: each stage's, summed in stage order
        # (over the pp line in the distributed schedule)
        dconsts = []
        for i, (shape, dtype, fl) in enumerate(ctx.shapes[n:]):
            if not fl:
                dconsts.append(None)
                continue
            g = None
            for st in sorted(acc):
                gi = acc[st][n + i]
                gi = torch.zeros(shape, dtype=dtype, device=dy_mb.device) \
                    if gi is None else gi
                g = gi if g is None else g + gi
            if line.distributed:
                g = line.sum_over(g, line.group, line.num_stages,
                                  "pp.consts", line.axis)
            dconsts.append(g)
        if eng.batch is not None:
            group, world, axis = eng.batch
            dparams = [None if g is None else line.sum_over(
                g, group, world, "pp.params", axis) for g in dparams]
            dconsts = [None if g is None else line.sum_over(
                g, group, world, "pp.consts", axis) for g in dconsts]
        return (None, dx_mb, None) + tuple(dparams) + tuple(dconsts)


def _stacked_slices(line):
    """Parameter inputs of leading size S (every stage's, in one process)
    or 1 (this rank's own stage) -> {stage: its slices}."""
    def slices(params):
        return {st: [p[0] if line.distributed or p.shape[0] == 1
                     else p[st] for p in params] for st in line.stages}
    return slices


def _stacked_assemble(line, device):
    """The stages' gradients of each stacked parameter input stacked
    back onto its leading dim (zeros where a stage gave none)."""
    def assemble(acc, shapes):
        out = []
        for i, (shape, dtype, fl) in enumerate(shapes):
            if not fl:
                out.append(None)
                continue
            out.append(torch.stack([
                torch.zeros(shape[1:], dtype=dtype, device=device)
                if acc[st][i] is None else acc[st][i]
                for st in line.stages]))
        return out
    return assemble


def run_stacked(line, stage_call, params, consts, x, num_micro, schedule,
                batch=None):
    """The stacked pipeline over ``line`` on ``x`` (this process's rows
    ``[b, ...]``): ``params`` of leading size S (all stages in this
    process) or 1 (this rank's stage), ``consts`` the values every stage
    reads; ``stage_call(params_list, consts_list, act)``. Differentiable
    (the schedule's backward) where an input needs a gradient. Returns
    ``[b, ...]`` on every stage of the line."""
    m = num_micro
    x_mb = split_microbatches(x, m)
    eng = _Engine(line, lambda st, p, c, a: stage_call(p, c, a),
                  _stacked_slices(line), _stacked_assemble(line, x.device),
                  schedule, batch)
    tensors = list(params) + list(consts)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in tensors)):
        y_mb = _PipelineFn.apply(eng, x_mb, len(params), *tensors)
    else:
        with torch.no_grad():
            outs, _ = _forward(eng, x_mb, eng.slices(params), list(consts))
            y_mb = _gather_out(eng, outs, x_mb)
    return join_microbatches(y_mb)


# ---- the plain functions (the JAX package's signatures) ----

class _Own(torch.autograd.Function):
    """This rank's stage slice ``[1, ...]`` of a stacked ``[S, ...]``
    parameter; the backward gathers every stage's slice gradient over
    the pp line, so each rank holds the whole ``[S, ...]`` gradient (the
    global view)."""

    @staticmethod
    def forward(ctx, p, stage, line):
        ctx.line, ctx.stage = line, stage
        return p[stage:stage + 1].clone()

    @staticmethod
    def backward(ctx, g):
        line = ctx.line
        out = gather_line(g, line.group, line.num_stages, line._census(),
                          "pp.grads", line.axis)
        return out.reshape((line.num_stages,) + tuple(g.shape[1:])), \
            None, None


class _Rows(torch.autograd.Function):
    """Rank ``rank``'s share of each microbatch's rows (of ``world``);
    the backward all-gathers the shares' gradients (the global x's)."""

    @staticmethod
    def forward(ctx, x_mb, rank, world, group):
        ctx.world, ctx.group = world, group
        b = x_mb.shape[1] // world
        return x_mb[:, rank * b:(rank + 1) * b].clone()

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.world, ctx.group), None, None, None


class _Gather(torch.autograd.Function):
    """Every rank's share of each microbatch's rows, gathered; the
    backward keeps this rank's rows of the (global) cotangent."""

    @staticmethod
    def forward(ctx, y_mb, rank, world, group):
        ctx.rank, ctx.b = rank, y_mb.shape[1]
        return _gather_rows(y_mb, world, group)

    @staticmethod
    def backward(ctx, g):
        r, b = ctx.rank, ctx.b
        return g[:, r * b:(r + 1) * b].contiguous(), None, None, None


def _gather_rows(t, world, group):
    """[M, b, ...] of each rank -> [M, world * b, ...], ranks in order
    within each microbatch."""
    return gather_line(t, group, world).movedim(0, 1).reshape(
        (t.shape[0], world * t.shape[1]) + tuple(t.shape[2:]))


def _mesh_line(mesh, axis, num_micro):
    s = mesh.shape[axis]
    num_micro = num_micro or s
    assert num_micro % s == 0, (num_micro, s)
    line = _Line(s, stage=mesh.axis_rank(axis), ranks=mesh.line(axis),
                 group=mesh.axis_group(axis), axis=axis)
    return line, num_micro


def _batch_of(mesh, batch_axis):
    if batch_axis and batch_axis in mesh.axis_names \
            and mesh.shape[batch_axis] > 1:
        return (mesh.axis_group(batch_axis), mesh.shape[batch_axis],
                batch_axis)
    return None


def _stacked_fn(stage_fn, mesh, axis, num_micro, batch_axis, schedule,
                with_consts):
    line, m = _mesh_line(mesh, axis, num_micro)
    batch = _batch_of(mesh, batch_axis)
    st = line.stages[0]

    def fn(*args):
        if with_consts:
            stacked_params, consts, x = args
        else:
            (stacked_params, x), consts = args, []
        pflat, pspec = pytree.tree_flatten(stacked_params)
        cflat, cspec = pytree.tree_flatten(consts)
        own = [_Own.apply(p, st, line) if p.shape[0] == line.num_stages
               and line.num_stages > 1 else p for p in pflat]

        def call(pl, cl, act):
            p = pytree.tree_unflatten(pl, pspec)
            if with_consts:
                return stage_fn(p, pytree.tree_unflatten(cl, cspec), act)
            return stage_fn(p, act)

        x_mb = split_microbatches(x, m)
        if batch is not None:
            group, world, _ = batch
            x_mb = _Rows.apply(x_mb, mesh.axis_rank(batch_axis), world,
                               group)
        y = run_stacked(line, call, own, cflat, join_microbatches(x_mb), m,
                        schedule, batch)
        y_mb = split_microbatches(y, m)
        if batch is not None:
            y_mb = _Gather.apply(y_mb, mesh.axis_rank(batch_axis), world,
                                 group)
        return join_microbatches(y_mb)

    #: {stage: the most stage inputs the 1F1B backward held at once}
    fn.peak = line.peak
    return fn


def pipeline_parallel_stacked(stage_fn, mesh, axis="pp", num_micro=None,
                              batch_axis=None):
    """True pipeline parallelism for homogeneous stages: ONE ``stage_fn
    (params_slice, act) -> act`` applied with per-stage parameter
    slices, on the GPipe schedule.

    Returns ``fn(stacked_params, x) -> y``, called on every rank of the
    mesh: every leaf of ``stacked_params`` has a leading stage dim, the
    whole ``[S, ...]`` (this rank takes its stage's slice, and its
    gradient is the whole ``[S, ...]`` one, gathered over the pp line)
    or this rank's own ``[1, ...]`` slice (its gradient is that
    slice's). ``x`` is the global batch ``[B, ...]``; it is cut into
    ``num_micro`` (default S) microbatches and ``batch_axis`` cuts each
    microbatch's rows over its ranks (module docstring); ``y`` is the
    global output on every rank. Gradients of the parameters are summed
    over ``batch_axis``."""
    return _stacked_fn(stage_fn, mesh, axis, num_micro, batch_axis,
                       "gpipe", False)


def pipeline_1f1b(stage_fn, mesh, axis="pp", num_micro=None,
                  batch_axis=None):
    """The 1F1B schedule with full recompute, the memory-steady
    alternative to GPipe's kept graphs: ``stage_fn(params_slice, consts,
    act) -> act``; returns ``fn(stacked_params, consts, x) -> y`` (the
    contract of :func:`pipeline_parallel_stacked`, with the body's
    closed-over outer values as an explicit ``consts`` pytree).

    The forward is the GPipe forward (its bits); the backward runs the
    1F1B ticks (module docstring), stage ``st`` holding at most
    ``2(S-1-st)+1`` stashed inputs. The consts' gradients are summed
    over the pp line and ``batch_axis``, the parameters' over
    ``batch_axis``; integer consts get none. The parameter gradients are
    bitwise GPipe's."""
    return _stacked_fn(stage_fn, mesh, axis, num_micro, batch_axis,
                       "1f1b", True)


def pipeline_parallel(stage_fns, mesh, axis="pp", num_micro=None):
    """Build ``fn(stage_params, x) -> y`` running S heterogeneous stages
    as a GPipe pipeline: ``stage_fns[i](params_i, act) -> act`` with a
    uniform activation shape, ``stage_params`` a list of S pytrees. The
    rank of stage ``i`` runs ``stage_fns[i]``; ``x`` ([B, ...], the same
    on every rank) is split into ``num_micro`` (default S) microbatches;
    every rank of the pp line ends with the last stage's outputs (the
    JAX package's psum broadcast), and with every stage's parameter
    gradients (each summed over the line)."""
    line, m = _mesh_line(mesh, axis, num_micro)
    s = line.num_stages
    assert len(stage_fns) == s, (len(stage_fns), s)

    def fn(stage_params, x):
        flats, specs = zip(*(pytree.tree_flatten(p) for p in stage_params))
        offs = [0]
        for f in flats:
            offs.append(offs[-1] + len(f))
        def slices(ps):
            return {st: list(ps[offs[st]:offs[st + 1]])
                    for st in line.stages}

        def assemble(acc, shapes):
            out = []
            for st in range(s):
                for i in range(offs[st], offs[st + 1]):
                    shape, dtype, fl = shapes[i]
                    g = acc[st][i - offs[st]] if st in acc else None
                    if fl and (g is None):
                        g = torch.zeros(shape, dtype=dtype, device=x.device)
                    if fl and line.distributed:
                        g = line.sum_over(g, line.group, s, "pp.params",
                                          axis)
                    out.append(g if fl else None)
            return out

        eng = _Engine(line, lambda st, p, c, a: stage_fns[st](
            pytree.tree_unflatten(p, specs[st]), a), slices, assemble)
        tensors = [t for f in flats for t in f]
        x_mb = split_microbatches(x, m)
        if torch.is_grad_enabled() and (x.requires_grad or any(
                t.requires_grad for t in tensors)):
            y_mb = _HeteroFn.apply(eng, x_mb, len(tensors), *tensors)
        else:
            outs, _ = _forward(eng, x_mb, slices(tensors), [])
            y_mb = _gather_out(eng, outs, x_mb)
        return join_microbatches(y_mb)

    return fn


class _HeteroFn(_PipelineFn):
    """:class:`_PipelineFn` over per-stage parameter lists (every stage's
    gradient slot assembled by the engine)."""

    @staticmethod
    def backward(ctx, dy_mb):
        eng, n = ctx.eng, ctx.n_params
        line = eng.line
        dx, acc = _gpipe_backward(eng, ctx.graphs, ctx.leaves,
                                  dy_mb.contiguous())
        ctx.graphs = ctx.leaves = None
        dx_mb = torch.stack([dx[m] for m in range(dy_mb.shape[0])]) \
            if 0 in line.stages else None
        dx_mb = line.broadcast(dx_mb, 0, tuple(dy_mb.shape), dy_mb.dtype,
                               dy_mb.device, "dx")
        return (None, dx_mb, None) + tuple(eng.assemble(acc, ctx.shapes))


def pipeline_in_process(stage_fn, stacked_params, consts, x, num_micro,
                        schedule="gpipe", stats=None):
    """Every stage of a stacked pipeline in this process, on the
    schedule's ticks (a send is a hand-over): ``stage_fn(params_slice,
    consts, act)``, ``stacked_params`` a pytree of ``[S, ...]`` leaves,
    ``consts`` a pytree, ``x`` ``[B, ...]``. Differentiable: the
    backward is the schedule's (``'gpipe'`` or ``'1f1b'``). ``stats``: a
    dict that receives ``"peak"`` ({stage: the most stage inputs the
    1F1B backward held at once}) and ``"bound"`` ({stage: 2(S-1-st)+1}).
    The card runs the S-stage schedules this way (one NCCL rank a
    card)."""
    pflat, pspec = pytree.tree_flatten(stacked_params)
    cflat, cspec = pytree.tree_flatten(consts)
    s = int(pflat[0].shape[0])
    line = _Line(s)

    def call(pl, cl, act):
        return stage_fn(pytree.tree_unflatten(pl, pspec),
                        pytree.tree_unflatten(cl, cspec), act)

    y = run_stacked(line, call, pflat, cflat, x, num_micro, schedule)
    if stats is not None:
        stats["peak"] = line.peak
        stats["bound"] = {st: 2 * (s - 1 - st) + 1 for st in range(s)}
    return y
