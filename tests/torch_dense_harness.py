"""Runs one op's lowering in the JAX package and in the port on the same
numpy inputs, forward and backward, for the dense op library's tests
(``tests/test_torch_math_ops.py``, ``tests/test_torch_tensor_ops.py``).

Bounds: a float output within rtol 1e-5 plus 1e-6 of the largest
magnitude of the JAX value (fp32 math in another summation order); an
integer output exact, its dtype as the JAX package records it with
64-bit types off (int64 is int32). Gradients: the port's
``torch.autograd.grad`` through the lowering against ``jax.vjp`` of the
JAX lowering, with the same random cotangent on every float output, at
the same bound."""

import collections
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu_torch  # noqa: F401  (registers the port's lowerings)
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lower import PackedSeq as JSeq
from paddle_tpu.core.lower import TraceContext as JCtx
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lower import PackedSeq as TSeq
from paddle_tpu_torch.core.lower import TraceContext as TCtx

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

RTOL = 1e-5
AMAX = 1e-6

# a variable-length input: padded [B, T, ...] data and [B] lengths
Seq = collections.namedtuple("Seq", "data lengths")

_CANONICAL = {"int64": "int32", "uint64": "uint32", "float64": "float32"}


class Op:
    """The slice of an Operator a lowering reads."""

    def __init__(self, type, attrs, uid=1):
        self.type, self.attrs, self.uid = type, attrs, uid
        self.inputs, self.outputs = {}, {}


def seq(data, lengths):
    """A Seq whose padding is zero, as a fed PackedSeq's is."""
    data = np.array(data)
    for i, n in enumerate(lengths):
        data[i, n:] = 0
    return Seq(data, np.asarray(lengths, np.int32))


def _j(a):
    if isinstance(a, Seq):
        return JSeq(jnp.asarray(a.data), jnp.asarray(a.lengths))
    return jnp.asarray(a)


def _t(a):
    if isinstance(a, Seq):
        return TSeq(torch.from_numpy(np.array(a.data)),
                    torch.from_numpy(np.array(a.lengths)))
    return torch.from_numpy(np.array(a))


def _data(v):
    return v.data if isinstance(v, (JSeq, TSeq, Seq)) else v


def _host(d, lengths=False):
    """Each output slot's arrays; with ``lengths``, also a slot
    ``<slot>@lengths`` holding each sequence output's lengths (None for
    a dense output)."""
    out = {s: [None if v is None else np.asarray(_data(v)) for v in vals]
           for s, vals in d.items()}
    if lengths:
        for s, vals in d.items():
            out[s + "@lengths"] = [
                np.asarray(v.lengths) if isinstance(v, (JSeq, TSeq))
                else None for v in vals]
    return out


def _leaves(type, ins):
    """(slot, index) of every float input the op differentiates."""
    spec = treg.get(type)
    if spec.no_grad:
        return []
    return [(s, i) for s, vals in ins.items() if s not in spec.nondiff_inputs
            for i, v in enumerate(vals)
            if np.issubdtype(np.asarray(_data(v)).dtype, np.floating)]


def run_jax(type, ins, attrs, uid=1, lengths=False):
    op = Op(type, attrs, uid)
    out = jreg.get(type).lower(JCtx(key=jax.random.PRNGKey(0)).for_op(op),
                               {s: [_j(a) for a in v] for s, v in
                                ins.items()}, attrs, op)
    return _host(jreg.normalize_outputs(out), lengths)


def run_port(type, ins, attrs, uid=1, key=0, lengths=False):
    op = Op(type, attrs, uid)
    out = treg.get(type).lower(TCtx(key=key).for_op(op),
                               {s: [_t(a) for a in v] for s, v in
                                ins.items()}, attrs, op)
    return _host(treg.normalize_outputs(out), lengths)


def grads(type, ins, attrs, seed=0):
    """({(slot, i): dX} of the JAX lowering, the same of the port's) for
    one random cotangent on every float output."""
    leaves = _leaves(type, ins)
    op = Op(type, attrs)
    jspec, tspec = jreg.get(type), treg.get(type)

    def jfn(*xs):
        full = {s: [_j(a) for a in v] for s, v in ins.items()}
        for (s, i), x in zip(leaves, xs):
            full[s][i] = JSeq(x, full[s][i].lengths) \
                if isinstance(full[s][i], JSeq) else x
        out = jreg.normalize_outputs(jspec.lower(
            JCtx(key=jax.random.PRNGKey(0)).for_op(op), full, attrs, op))
        return tuple(_data(v) for s in sorted(out) for v in out[s]
                     if v is not None
                     and jnp.issubdtype(_data(v).dtype, jnp.floating))

    xs = [jnp.asarray(_data(ins[s][i])) for s, i in leaves]
    jout, vjp = jax.vjp(jfn, *xs)
    rng = np.random.RandomState(seed)
    cots = [np.asarray(rng.randn(*o.shape), np.float32) for o in jout]
    jg = vjp(tuple(jnp.asarray(c) for c in cots))

    full = {s: [_t(a) for a in v] for s, v in ins.items()}
    tx = []
    for s, i in leaves:
        x = _data(full[s][i]).clone().requires_grad_()
        tx.append(x)
        full[s][i] = TSeq(x, full[s][i].lengths) \
            if isinstance(full[s][i], TSeq) else x
    out = treg.normalize_outputs(tspec.lower(TCtx().for_op(op), full, attrs,
                                             op))
    touts = [_data(v) for s in sorted(out) for v in out[s]
             if v is not None and _data(v).is_floating_point()]
    assert len(touts) == len(cots), (len(touts), len(cots))
    pairs = [(o, torch.from_numpy(c)) for o, c in zip(touts, cots)
             if o.requires_grad]
    tg = torch.autograd.grad([o for o, _ in pairs], tx,
                             [c for _, c in pairs], allow_unused=True) \
        if pairs else [None] * len(tx)
    tg = [np.zeros(x.shape, np.float32) if g is None else g.numpy()
          for x, g in zip(tx, tg)]
    return ({k: np.asarray(g) for k, g in zip(leaves, jg)},
            dict(zip(leaves, tg)))


def close(got, want, what=""):
    """A float array within the bound of the module docstring."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    amax = float(np.nanmax(np.abs(want))) if want.size and \
        not np.isnan(want).all() else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=AMAX * amax,
                               err_msg=what)


def same(j, t):
    """Every output of two runs: floats within the bound, the rest
    exact with the JAX package's recorded dtype."""
    assert set(j) <= set(t), (sorted(j), sorted(t))
    for slot, vals in j.items():
        assert len(vals) == len(t[slot]), slot
        for a, b in zip(vals, t[slot]):
            if a is None:
                continue
            if np.issubdtype(a.dtype, np.floating):
                close(b, a, slot)
                assert b.dtype == a.dtype, (slot, b.dtype, a.dtype)
            else:
                assert b.shape == a.shape, (slot, b.shape, a.shape)
                np.testing.assert_array_equal(b, a, err_msg=slot)
                assert _CANONICAL.get(b.dtype.name, b.dtype.name) == \
                    a.dtype.name, (slot, b.dtype, a.dtype)


def check(type, ins, attrs, grad=True, lengths=False):
    """Forward outputs, then (``grad``) the gradients, both packages;
    with ``lengths``, each sequence output's lengths too, exact."""
    same(run_jax(type, ins, attrs, lengths=lengths),
         run_port(type, ins, attrs, lengths=lengths))
    if grad and _leaves(type, ins):
        jg, tg = grads(type, ins, attrs)
        for k in jg:
            close(tg[k], jg[k], "d%s[%d]" % k)
