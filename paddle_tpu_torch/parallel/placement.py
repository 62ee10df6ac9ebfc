"""Model parallelism as a searched placement: dp x mp x pp meshes.

Capability parity: the JAX package's ``parallel/placement.py``. The
reference hard-codes its parallel topology per trainer binary; here the
topology is a decision the same program structure can take: pure data
parallelism, tensor parallelism over an 'mp' axis (the Megatron
column/row splits whose collectives the comm layer's weight-locality
analysis places), pipeline parallelism over a 'pp' axis, or a product.
This module makes the decision searchable, statically:

* :class:`Placement` — one (dp, mp, pp) point; ``mesh_for`` builds its
  mesh over the ``torch.distributed`` world (unit axes dropped);
* :func:`legal_placements` — the candidates for a rank count that the
  model's divisibility contracts admit (heads % mp, layers % pp, batch %
  dp x micro), each counted in ``paddle_tpu_placement_candidates_total``;
* :func:`plan_stages` — pipeline cut points from the remat pass's
  live-activation minima (``passes.remat.plan_cuts``), proven gap-free
  by ``analysis.effects.check_stage_plan``;
* :func:`estimate_wire_bytes` — the static ring model (an all-reduce
  moves ``2 x payload x (g - 1) / g``, a boundary permute its payload
  once): dp's gradient all-reduce, each mp Megatron pair's activation
  once a direction, pp's boundary activation;
* :func:`hbm_report` — per-rank persistent bytes against a declared
  memory budget, the go/no-go that forces mp or pp;
* :func:`rank` — candidates ordered by modeled wire bytes.

Every function reads the program alone (no collective, no device): the
numbers are the JAX package's on the same program.
"""

import numpy as np

from paddle_tpu_torch import telemetry
from paddle_tpu_torch.parallel.mesh import make_mesh

__all__ = ["Placement", "legal_placements", "plan_stages", "hbm_report",
           "estimate_wire_bytes", "rank"]

_AXES = ("dp", "mp", "pp")


def _candidate_event(outcome):
    if telemetry.enabled():
        telemetry.counter(
            "paddle_tpu_placement_candidates_total",
            "placement-search candidate legality outcomes "
            "(legal/illegal)", labelnames=("outcome",)).inc(
                outcome=outcome)


class Placement:
    """One point of the topology space: axis extents (dp, mp, pp).

    Hashable via :attr:`key`; JSON-able via :meth:`describe`;
    ``mesh_for()`` builds the concrete mesh with the unit axes
    dropped (CommPlan accepts ``('dp',)`` / ``('dp', 'mp')`` meshes,
    the pipeline lowering keys on a ``'pp'`` axis being present)."""

    __slots__ = ("dp", "mp", "pp")

    def __init__(self, dp=1, mp=1, pp=1):
        self.dp, self.mp, self.pp = int(dp), int(mp), int(pp)
        if min(self.dp, self.mp, self.pp) < 1:
            raise ValueError("placement axes must be >= 1, got %r"
                             % ((dp, mp, pp),))

    @property
    def key(self):
        return (self.dp, self.mp, self.pp)

    @property
    def world(self):
        return self.dp * self.mp * self.pp

    @property
    def label(self):
        bits = ["%s%d" % (a, s) for a, s in zip(_AXES, self.key) if s > 1]
        return "x".join(bits) or "single"

    def axes(self):
        """((name, size), ...) with unit axes dropped — 'dp' kept when
        everything is 1 so the mesh always has a batch axis."""
        out = tuple((a, s) for a, s in zip(_AXES, self.key) if s > 1)
        return out or (("dp", 1),)

    def mesh_for(self, devices=None):
        """The placement's mesh over the world's ranks (``devices``: the
        global ranks to span), unit axes dropped; every rank of the world
        calls it (``make_mesh``); a 'pp' axis runs the ``pipeline`` op's
        schedule over its lines."""
        names, shape = zip(*self.axes())
        return make_mesh(tuple(shape), tuple(names), devices=devices)

    def describe(self):
        return {"dp": self.dp, "mp": self.mp, "pp": self.pp}

    def __repr__(self):
        return "Placement(dp=%d, mp=%d, pp=%d)" % self.key

    def __eq__(self, other):
        return isinstance(other, Placement) and self.key == other.key

    def __hash__(self):
        return hash(self.key)


def legal_placements(n_devices, num_heads=None, num_layers=None,
                     batch_size=None, num_micro=None):
    """Every (dp, mp, pp) with ``dp·mp·pp == n_devices`` that the
    model's own divisibility contracts admit — the static twin of the
    runtime errors each axis raises on an illegal extent:

    * ``mp`` must divide ``num_heads`` (head-split fused attention
      shards the head axis) — and the Megatron ffn column split rides
      the same factor since d_ff is a multiple of d_model in every
      config this repo builds;
    * ``pp`` must divide ``num_layers`` (the stage sub-block repeats
      ``layers/pp`` decoder blocks) and ``pp > 1`` needs at least 2
      layers per pipeline to be worth a stage boundary;
    * ``dp`` (times ``num_micro`` under pp) must divide
      ``batch_size`` — the microbatch split is exact, never padded.

    Filters only apply when their model dimension is given; each
    candidate increments ``paddle_tpu_placement_candidates_total``
    with its legality outcome."""
    n = int(n_devices)
    out = []
    for dp in range(1, n + 1):
        if n % dp:
            continue
        for mp in range(1, n // dp + 1):
            if (n // dp) % mp:
                continue
            pp = n // (dp * mp)
            p = Placement(dp, mp, pp)
            legal = True
            if num_heads is not None and num_heads % mp:
                legal = False
            if num_layers is not None and (
                    num_layers % pp or (pp > 1 and num_layers < pp)):
                legal = False
            if batch_size is not None:
                micro = (num_micro or pp) if pp > 1 else 1
                if batch_size % (dp * max(1, micro)):
                    legal = False
            _candidate_event("legal" if legal else "illegal")
            if legal:
                out.append(p)
    return sorted(out, key=lambda p: p.key)


def plan_stages(program, pp):
    """Pipeline stage boundaries for ``pp`` stages, reused from the
    remat pass's live-activation minima (``passes.remat.plan_cuts`` —
    the narrow points between decoder blocks where only the residual
    stream is live). Returns ``(bounds, fwd_end)`` with
    ``len(bounds) == pp + 1``, proven gap-free / monotone by
    ``analysis.effects.check_stage_plan``; raises ValueError when the
    forward region cannot support ``pp`` stages (so the placement
    search drops the candidate instead of building a torn pipeline)."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.passes import remat

    pp = int(pp)
    if pp < 1:
        raise ValueError("plan_stages: pp must be >= 1, got %d" % pp)
    planned = remat.plan_cuts(program, pp)
    if planned is None:
        raise ValueError(
            "plan_stages: program has no usable forward region / "
            "activation minima to cut %d pipeline stages from" % pp)
    bounds, fwd_end = planned
    if len(bounds) - 1 != pp:
        raise ValueError(
            "plan_stages: the forward dataflow only supports %d stage "
            "boundaries at its live-activation minima, not pp=%d"
            % (len(bounds) - 1, pp))
    analysis.effects.check_stage_plan(bounds, fwd_end, program)
    return bounds, fwd_end


def _var_nbytes(v, batch=1):
    """Byte size of one declared var; -1 (batch) dims count ``batch``."""
    shape = getattr(v, "shape", None)
    if not shape:
        return 0
    n = 1
    for d in shape:
        d = int(d)
        n *= batch if d < 0 else (d if d else 1)
    try:
        item = np.dtype(str(getattr(v, "dtype", "float32"))).itemsize
    except TypeError:
        item = 4
    return n * item


def _shard_factor(v, placement, owners):
    """How many ways a persistent var's bytes divide under the
    placement: 'mp' in its sharding spec -> /mp, a pp-stacked stage
    var -> /pp; optimizer accumulators inherit their owner's factor
    when the shapes match (scalar beta-pow carries stay replicated)."""
    f = 1
    spec = getattr(v, "sharding", None) or ()
    if "mp" in spec:
        f *= placement.mp
    if getattr(v, "pp_stages", None):
        f *= placement.pp
    if f == 1:
        owner = owners.get(getattr(v, "optimizer_state_for", None))
        if owner is not None and tuple(getattr(v, "shape", ()) or ()) \
                == tuple(getattr(owner, "shape", ()) or ()):
            return _shard_factor(owner, placement, {})
    return f


def hbm_report(program, placement, hbm_budget=None):
    """Per-device persistent (parameter + optimizer-state) bytes under
    ``placement`` vs a declared per-device memory budget — the static
    go/no-go that forces mp/pp when the model exceeds one card.
    Activations are deliberately excluded (batch-dependent; remat owns
    that ledger) — this is the RESIDENT floor no schedule can move."""
    blk = program.global_block()
    owners = {name: v for name, v in blk.vars.items()
              if getattr(v, "is_parameter", False)}
    total = per_device = 0
    for name, v in blk.vars.items():
        if not getattr(v, "persistable", False):
            continue
        n = _var_nbytes(v)
        total += n
        per_device += n // _shard_factor(v, placement, owners)
    out = {"placement": placement.describe(), "total_bytes": total,
           "per_device_bytes": per_device,
           "budget_bytes": hbm_budget}
    if hbm_budget is not None:
        out["fits"] = per_device <= int(hbm_budget)
    return out


def _mp_kind(v):
    """'col' / 'row' / None from a weight's declared sharding spec —
    the same convention the comm layer's weight-locality trace keys
    on: last dim on 'mp' = column split, first dim = row split. A
    pipeline-stacked weight's leading 'pp' stage axis is stripped."""
    spec = tuple(getattr(v, "sharding", None) or ())
    if spec and spec[0] == "pp" and getattr(v, "pp_stages", None):
        spec = spec[1:]
    if not spec or "mp" not in spec:
        return None
    return "col" if spec[-1] == "mp" else "row"


def estimate_wire_bytes(program, placement, batch=1):
    """Static per-step per-device wire bytes under ``placement``, by
    the bandwidth-optimal ring model (all-reduce ~= 2·payload·(g-1)/g,
    a boundary permute moves its payload once; ``comm_audit``'s census
    charges the collectives a step issues by the same model):

    * **dp** — one gradient all-reduce of the per-device trainable
      bytes (mp/pp-sharded params contribute their SHARD's grad);
    * **mp** — each Megatron pair all-reduces one full activation per
      direction: the row matmul's output forward, the column matmul's
      input gradient backward;
    * **pp** — the stage boundary activation crosses each of the
      ``pp - 1`` cuts once per microbatch, forward (activation) and
      backward (its cotangent).

    ``batch`` resolves -1 feed dims (the GLOBAL batch; dp and the
    microbatch split divide it). Returns the per-axis breakdown plus
    ``total`` — the rank key. A model, not a measurement: exact enough
    to order candidates, honest enough to say so."""
    blk = program.global_block()
    dp, mp, pp = placement.key
    per_dp_batch = max(1, batch // dp)

    # dp: gradient ring all-reduce over the per-device param shard
    grad_bytes = 0
    owners = {name: v for name, v in blk.vars.items()
              if getattr(v, "is_parameter", False)}
    for name, v in owners.items():
        if not getattr(v, "trainable", True):
            continue
        grad_bytes += _var_nbytes(v) // _shard_factor(v, placement, {})
    dp_bytes = int(2 * grad_bytes * (dp - 1) / dp) if dp > 1 else 0

    # mp: the trace-placed Megatron collectives, statically mirrored.
    # Under pp the Megatron matmuls live in the pipeline SUB-block and
    # run once per microbatch per stage repeat — micro · microbatch
    # bytes = the per-dp batch again, so the per-step volume is the
    # same expression either way.
    mp_bytes = 0
    if mp > 1:
        for block in program.blocks:
            for op in block.ops:
                if op.type not in ("mul", "matmul"):
                    continue
                y = (op.inputs.get("Y") or (None,))[0]
                kind = _mp_kind(
                    block._find_var_recursive(y) if y else None)
                if kind is None and y:
                    # a stage sub-block reads an unsharded SHADOW of
                    # the [S]-stacked global weight — that one carries
                    # the ('pp', ...) + 'mp' spec
                    kind = _mp_kind(blk.vars.get(y))
                if kind is None:
                    continue
                if kind == "row":
                    names = op.outputs.get("Out") or ()
                else:
                    names = op.inputs.get("X") or ()
                v = block._find_var_recursive(names[0]) if names else None
                if v is None:
                    continue
                act = _var_nbytes(v, batch=per_dp_batch)
                mp_bytes += int(2 * act * (mp - 1) / mp)

    # pp: boundary ppermutes, one per microbatch per cut, fwd + bwd
    # (the boundary var is declared in the stage sub-block)
    pp_bytes = 0
    if pp > 1:
        for op in blk.ops:
            if op.type != "pipeline":
                continue
            sub = program.block(op.attrs["sub_block_id"])
            v = sub._find_var_recursive(op.attrs["in_name"])
            micro = int(op.attrs.get("num_micro") or pp)
            if v is None or not micro:
                continue
            mb = _var_nbytes(v, batch=max(1, per_dp_batch // micro))
            pp_bytes += 2 * mb * micro * (pp - 1)

    return {"dp": dp_bytes, "mp": mp_bytes, "pp": pp_bytes,
            "total": dp_bytes + mp_bytes + pp_bytes}


def rank(placements, build, batch=1):
    """Statically order candidates: ``build(placement)`` returns the
    program REBUILT for that placement's axes (mp splits and pp stages
    change the program structure, so each candidate ranks its own
    build); rows come back cheapest-wire first, each with its byte
    breakdown and resident-memory floor. Sets the per-candidate
    ``paddle_tpu_placement_wire_bytes`` gauge so the decision is
    observable before any measurement runs."""
    rows = []
    for p in placements:
        prog = build(p)
        est = estimate_wire_bytes(prog, p, batch=batch)
        rows.append({"placement": p, "wire": est,
                     "hbm": hbm_report(prog, p)})
        if telemetry.enabled():
            telemetry.gauge(
                "paddle_tpu_placement_wire_bytes",
                "modeled per-step per-device wire bytes of one "
                "placement candidate (static ring model)",
                labelnames=("placement",)).set(
                    est["total"], placement=p.label)
    rows.sort(key=lambda r: (r["wire"]["total"],
                             r["placement"].key))
    return rows
