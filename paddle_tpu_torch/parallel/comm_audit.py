"""A census of the collectives a parallel step issues: the port's
structural audit of the gradient exchange and the tensor axis.

Capability parity: the collective checks of the JAX package's
``parallel/hlo_audit.py``, which parses the compiled HLO for its
all-reduce, all-gather, reduce-scatter and all-to-all instructions,
their payloads, wire bytes and their place among the backward's dots.
The port compiles no HLO: its comm layer records each collective as it
issues it (:class:`Census`, one a step, kept on the executor as
``last_census``), with its kind, dtype, elements, modeled wire bytes,
the op after which it was launched, what it carried (a bucket, the
loss mean, batch-norm statistics, a fetch, a parameter gather, a
Megatron all-reduce, a ring step) and the mesh axis it ran over.
:func:`axis_stats` attributes the census per axis, the counterpart of
``hlo_audit.axis_stats``.

On the card, :func:`device_collectives` reads a ``torch.profiler``
trace of one eager step for the NCCL work it ran, which
``chip_smoke.py`` holds against the census.
"""

__all__ = ["Census", "collective_stats", "axis_stats", "bucket_overlap",
           "device_collectives"]


class Census:
    """The collectives of one step, in issue order: dicts with
    ``kind`` ("all_to_all" / "all_gather" / "all_reduce" /
    "send_recv"), ``dtype``, ``elements``, ``wire_bytes`` (per rank,
    ring model: ``bytes * (world - 1) / world`` of the moved buffer,
    twice that for an all-reduce, the whole buffer for a ring step),
    ``after_uid`` (the uid of the op after which it was launched, or of
    the op whose lowering issued it), ``tag`` ("bucket<i>",
    "bucket<i>.scale", "sum", "bn_stats", "bn_grad", "fetch", "param",
    "mp.fwd_row", "mp.bwd_col", "mp.param", "ring", ...) and ``axis``,
    the mesh axis its group spans ("dp", "mp", "sp"; "dpxsp" where the
    group is a two-axis mesh's every rank)."""

    def __init__(self, program=None):
        self.records = []
        # the program the step ran (an executor plan's: the pass
        # pipeline's clone where the program has a pass config)
        self.program = program

    def add(self, kind, dtype, elements, wire_bytes, after_uid, tag,
            axis="dp"):
        self.records.append({"kind": kind, "dtype": dtype,
                             "elements": int(elements),
                             "wire_bytes": int(wire_bytes),
                             "after_uid": int(after_uid), "tag": tag,
                             "axis": axis})

    def __len__(self):
        return len(self.records)

    def count(self, tag_prefix=None):
        return sum(1 for r in self.records
                   if tag_prefix is None or r["tag"].startswith(tag_prefix))


def collective_stats(census):
    """{kind: {"count", "elements", "wire_bytes"}} over a census (the
    shape of ``hlo_audit.collective_stats``)."""
    out = {}
    for r in census.records:
        s = out.setdefault(r["kind"], {"count": 0, "elements": 0,
                                       "wire_bytes": 0})
        s["count"] += 1
        s["elements"] += r["elements"]
        s["wire_bytes"] += r["wire_bytes"]
    return out


def axis_stats(census):
    """{axis: {kind: {"count", "elements", "wire_bytes"}}}: the census
    attributed per mesh axis (the shape of ``hlo_audit.axis_stats``).
    Every record names its axis, so the per-axis counts sum to the flat
    census (:func:`collective_stats`)."""
    out = {}
    for r in census.records:
        s = out.setdefault(r["axis"], {}).setdefault(
            r["kind"], {"count": 0, "elements": 0, "wire_bytes": 0})
        s["count"] += 1
        s["elements"] += r["elements"]
        s["wire_bytes"] += r["wire_bytes"]
    return out


def bucket_overlap(census, program=None):
    """{bucket index: True when the bucket's gradient exchange was
    launched before the program's last backward op} — the overlap the
    comm layer promises (its exchange runs while the rest of the
    backward computes). ``program`` defaults to the census's."""
    ops = (program or census.program).global_block().ops
    pos = {op.uid: i for i, op in enumerate(ops)}
    grad_pos = [i for i, op in enumerate(ops) if op.type.endswith("_grad")]
    last = max(grad_pos) if grad_pos else len(ops)
    out = {}
    for r in census.records:
        tag = r["tag"]
        if not tag.startswith("bucket") or "." in tag:
            continue
        b = int(tag[len("bucket"):])
        if b not in out:
            out[b] = pos.get(r["after_uid"], len(ops)) < last
    return out


def device_collectives(prof):
    """(host calls, device ranges, device microseconds) of the NCCL work
    in a finished ``torch.profiler.profile`` that recorded the CPU and
    the card: PyTorch names each NCCL call ``nccl:<collective>`` on the
    host, and mirrors it on the device timeline as a range of the same
    name (at one rank NCCL moves the data by a device copy inside it).
    The host calls are the count to hold against a census: the profiler
    may drop a device range of the thousands a step records."""
    import torch

    host = dev = 0
    us = 0.0
    for e in prof.events():
        if not e.name.startswith("nccl:"):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev += 1
            us += e.time_range.elapsed_us()
        else:
            host += 1
    return host, dev, us
