"""Context parallelism ('sp': ring attention over B1) of the port against
the JAX package's, at gloo worlds on the CPU and in one process.

For each world (2 and 4 ranks) one spawn of this file as a script runs
the port's side (tests/torch_gloo_harness.py), while the test process
runs the JAX package's:

* **the ring**: ``context_parallel.context_parallel_attention`` over an
  ``('sp',)`` mesh of the world's ranks, non-causal and causal, without
  and with segment ids whose boundary (position 40 of 64) is off a
  shard edge, and at ``(dp, sp) = (2, 2)`` with the batch over dp
  (world 4). Each rank holds its block of the global q, k, v; the
  blocks of the output and of dq, dk, dv (of ``sum(out ** 2)``, through
  the ring's own backward) are put together and held against the JAX
  package's ``context_parallel_attention`` on the same mesh of its CPU
  devices within rtol and atol 2e-5, and against ``jax.grad`` of its
  full attention reference (``mha_reference``) within 2e-4: the bounds
  of tests/test_attention.py:71-118;
* **sp on the transformer** (world 4): ``build_transformer_lm(seq_axis=
  'sp')`` (V 64, L 16, d 32, 2 layers, 4 heads, batch 8, Adam 1e-2)
  through ``ParallelExecutor`` in the global view over a ``(dp, sp) =
  (2, 2)`` mesh (ZeRO-1, the default), 2 steps from the JAX startup's
  weights, against the JAX package's single-device ``Executor``: losses
  within 1e-4, states within rtol 2e-4, atol 2e-5, each Adam-trained
  parameter also within twice the two packages' serial runs' distance
  on it (tests/test_torch_tensor_parallel.py's docstring: Adam carries
  a near-cancelling gradient's rounding into its step).

In one process (``ring_in_process``, the same blocks, merges and block
backwards for every rank of a ring): the ring of 4 is full attention
(out, lse, dq, dk, dv) and a float64 witness; the ring of 1 is B1's
plain version and ``flash_attention_bwd`` bit for bit; B1 runs n(n+1)/2
blocks when causal, n^2 when not; a block that sees no key of a row
weighs 0 in the merge.
"""

import os
import shutil
import sys
import tempfile

import numpy as np
import pytest
import torch

import test_torch_tensor_parallel as tt
import torch_gloo_harness as gh

TIMEOUT = 150
#: ring cases: name -> (mesh shape, axes, [b, h, s, d], causal,
#: segments, batch axis); "sp" cases take the world's size
RING = {
    "full": (None, ("sp",), (2, 2, 64, 8), False, False, None),
    "causal": (None, ("sp",), (2, 2, 64, 8), True, False, None),
    "seg": (None, ("sp",), (1, 2, 64, 8), False, True, None),
    "seg_causal": (None, ("sp",), (1, 2, 64, 8), True, True, None),
    "dp_sp": ((2, 2), ("dp", "sp"), (4, 2, 32, 8), True, False, "dp"),
}
WORLDS = (2, 4)


def ring_cases(world):
    return [n for n in RING if RING[n][0] is None or world == 4]


def mesh_shape(name, world):
    return RING[name][0] or (world,)


def ring_inputs(name):
    """(q, k, v, segment ids [b, s] or None) of a case, float32."""
    _, _, (b, h, s, d), _, seg, _ = RING[name]
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    ids = None
    if seg:
        ids = np.zeros((b, s), np.int32)
        ids[:, 40:] = 1   # not on a shard edge (16 or 32 a shard)
    return q, k, v, ids


def block_of(shape, axes, index, a, time_dim):
    """Mesh index ``index``'s block of ``a``: its rows over dp, its time
    chunk (dimension ``time_dim``) over sp."""
    coords, rest = {}, index
    for ax, n in reversed(list(zip(axes, shape))):
        coords[ax] = rest % n
        rest //= n
    if "dp" in coords:
        n = a.shape[0] // shape[axes.index("dp")]
        a = a[coords["dp"] * n:(coords["dp"] + 1) * n]
    sp = shape[axes.index("sp")]
    n = a.shape[time_dim] // sp
    return np.take(a, range(coords["sp"] * n, (coords["sp"] + 1) * n),
                   axis=time_dim)


def assemble(shape, axes, parts, time_dim):
    """The global array from each mesh index's block (``block_of``'s
    inverse)."""
    dp = shape[axes.index("dp")] if "dp" in axes else 1
    sp = shape[axes.index("sp")]
    rows = []
    for r in range(dp):
        rows.append(np.concatenate([parts[r * sp + c] for c in range(sp)],
                                   axis=time_dim))
    return np.concatenate(rows, axis=0)


# ---- the port's side: one process a rank ----

def _worker(rank, world, d):
    gh.join(rank, world, d, TIMEOUT)
    import paddle_tpu_torch as fl
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.parallel import ParallelExecutor, make_mesh
    from paddle_tpu_torch.parallel.context_parallel import (
        context_parallel_attention)

    for name in ring_cases(world):
        shape, axes, _, causal, _, batch_axis = RING[name]
        shape = mesh_shape(name, world)
        mesh = make_mesh(shape, axes)
        q, k, v, ids = ring_inputs(name)
        leaves = [torch.from_numpy(np.ascontiguousarray(
            block_of(shape, axes, rank, a, 2))).requires_grad_()
            for a in (q, k, v)]
        seg = None
        if ids is not None:
            mine = torch.from_numpy(np.ascontiguousarray(
                block_of(shape, axes, rank, ids, 1)))
            seg = (mine, mine)
        out = context_parallel_attention(*leaves, mesh, axis="sp",
                                         causal=causal,
                                         batch_axis=batch_axis,
                                         segment_ids=seg)
        (out ** 2).sum().backward()
        np.savez(os.path.join(d, "ring_%s_r%d.npz" % (name, rank)),
                 out=out.detach().numpy(),
                 **{g: t.grad.numpy() for g, t in zip(("dq", "dk", "dv"),
                                                      leaves)})
    if world == 4:
        prog, startup, loss = tt.build_tfm(fl, seq_axis="sp")
        scope = fl.Scope()
        with np.load(os.path.join(d, "tfm_init.npz")) as z:
            interop.load_reference_state({n: z[n] for n in z.files}, scope,
                                         fl.CPUPlace(), [prog, startup])
        pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                              main_program=prog,
                              mesh=make_mesh((2, 2), ("dp", "sp")),
                              seq_axis="sp")
        losses = [pe.run(feed=tt.tfm_feed(s), fetch_list=[loss.name],
                         scope=scope)[0] for s in range(tt.TFM_STEPS)]
        state = gh.snapshot(scope)
        if rank == 0:
            np.savez(os.path.join(d, "out_tfm.npz"),
                     losses=np.stack(losses),
                     **{"s:" + n: v for n, v in state.items()})
    gh.leave()


# ---- the JAX side, in the test process ----

def _jax_ring(name, world):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.kernels.flash_attention import mha_reference
    from paddle_tpu.parallel import make_mesh
    from paddle_tpu.parallel.context_parallel import (
        context_parallel_attention)

    shape, axes, _, causal, _, batch_axis = RING[name]
    q, k, v, ids = ring_inputs(name)
    seg = None if ids is None else (ids, ids)
    out = context_parallel_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        make_mesh(mesh_shape(name, world), axes), axis="sp", causal=causal,
        batch_axis=batch_axis, segment_ids=seg)
    jseg = None if ids is None else (jnp.asarray(ids), jnp.asarray(ids))
    grads = jax.grad(lambda a, b, c: jnp.sum(mha_reference(
        a, b, c, causal=causal, segment_ids=jseg) ** 2),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _jax_tfm_serial(d):
    """The JAX package's single-device run; writes its startup's weights
    for the port first."""
    import paddle_tpu as fl

    prog, startup, loss = tt.build_tfm(fl, seq_axis="sp")
    scope = fl.Scope()
    with fl.scope_guard(scope):
        exe = fl.Executor()
        exe.run(startup)
        names = [n for n in scope.local_var_names()
                 if hasattr(scope.find_var(n), "shape")]
        np.savez(os.path.join(d, "tfm_init.npz"),
                 **{n: np.asarray(scope.find_var(n)) for n in names})
        losses = [float(np.asarray(exe.run(prog, feed=tt.tfm_feed(s),
                                           fetch_list=[loss.name])[0]))
                  for s in range(tt.TFM_STEPS)]
        state = {n: np.asarray(scope.find_var(n)) for n in names
                 if not n.startswith("__")}
    return losses, state


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: "world%d" % w)
def world_run(request):
    """One spawn of a world's ranks while the JAX runs go on here:
    (world, {case: (port out, port grads, JAX out, JAX grads)}, the
    transformer's (port, JAX, the serial gap) at world 4)."""
    world = request.param
    d = tempfile.mkdtemp(prefix="ptp_sp_")
    try:
        jtfm = _jax_tfm_serial(d) if world == 4 else None
        started = gh.start(__file__, world, d, TIMEOUT)
        try:
            jring = {n: _jax_ring(n, world) for n in ring_cases(world)}
            gap = None
            if world == 4:
                js, ps = tt.serial_runs(d)
                gap = {n: float(np.abs(ps[n] - js[n]).max()) for n in js}
        finally:
            gh.finish(started, d)
        ring = {}
        for name in ring_cases(world):
            shape, axes = mesh_shape(name, world), RING[name][1]
            parts = [np.load(os.path.join(d, "ring_%s_r%d.npz"
                                          % (name, r))) for r in range(world)]
            got = {k: assemble(shape, axes, [p[k] for p in parts], 2)
                   for k in ("out", "dq", "dk", "dv")}
            ring[name] = (got, jring[name])
        tfm = None
        if world == 4:
            with np.load(os.path.join(d, "out_tfm.npz")) as z:
                ptfm = (list(z["losses"]), {k[2:]: z[k] for k in z.files
                                            if k.startswith("s:")})
            tfm = (ptfm, jtfm, gap)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return world, ring, tfm


def _ring_matches(ring, name):
    got, (jout, jgrads) = ring[name]
    np.testing.assert_allclose(got["out"], jout, rtol=2e-5, atol=2e-5)
    for g, want in zip(("dq", "dk", "dv"), jgrads):
        np.testing.assert_allclose(got[g], want, rtol=2e-4, atol=2e-4,
                                   err_msg=g)


@pytest.mark.parametrize("name", [n for n in RING if RING[n][0] is None])
def test_ring_matches_the_jax_ring_and_its_gradients(world_run, name):
    _ring_matches(world_run[1], name)


@pytest.mark.parametrize("world_run", [4], indirect=True, ids=["world4"])
def test_dp_sp_ring_matches_the_jax_ring_and_its_gradients(world_run):
    _ring_matches(world_run[1], "dp_sp")


@pytest.mark.parametrize("world_run", [4], indirect=True, ids=["world4"])
def test_transformer_sp_matches_the_jax_single_device_run(world_run):
    (pl, ps), (jl, js), gap = world_run[2]
    for a, b in zip(pl, jl):
        assert abs(float(a) - b) < 1e-4 * max(1.0, abs(b)), (pl, jl)
    assert set(js) <= set(ps), set(js) - set(ps)
    for n in sorted(js):
        assert ps[n].shape == js[n].shape, n
        extra = 2.0 * gap[n] if tt.adam_param(n) else 0.0
        assert np.allclose(ps[n], js[n], rtol=2e-4, atol=2e-5 + extra), (
            n, np.max(np.abs(ps[n] - js[n])), extra)


# ---- in one process: the ring's blocks ----

def _qkv(b=2, h=2, s=64, d=8, seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, h, s, d, generator=g).to(dtype)
            for _ in range(3)]


def _segments(b, s, at=40):
    ids = torch.zeros(b, s, dtype=torch.int32)
    ids[:, at:] = 1
    return ids, ids


def _float64(q, k, v, causal, seg):
    """Softmax attention in float64 with autograd: (out, lse, dq, dk,
    dv) of sum(out ** 2)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    ok = torch.ones(s.shape[-2:], dtype=torch.bool)
    if causal:
        ok = torch.tril(ok)
    ok = ok[None, None]
    if seg is not None:
        ok = ok & (seg[0][:, None, :, None] == seg[1][:, None, None, :])
    s = torch.where(ok, s, fa.DEFAULT_MASK_VALUE)
    lse = torch.logsumexp(s, -1)
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
    dq, dk, dv = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    return out.detach(), lse.detach(), dq, dk, dv


@pytest.mark.parametrize("causal,seg", [(False, False), (True, False),
                                        (False, True), (True, True)],
                         ids=["full", "causal", "seg", "seg_causal"])
def test_ring_in_process_is_full_attention(causal, seg):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import context_parallel as cp

    q, k, v = _qkv()
    segs = _segments(2, 64) if seg else None
    out, lse = cp.ring_in_process(q, k, v, 4, causal, segment_ids=segs)
    ro, rl = fa.flash_attention_reference(q, k, v, causal, None, segs)
    torch.testing.assert_close(out, ro, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse, rl, rtol=2e-5, atol=2e-5)
    dq, dk, dv = cp.ring_in_process_bwd(q, k, v, out, lse, 2 * out, 4,
                                        causal, segment_ids=segs)
    w = _float64(q, k, v, causal, segs)
    torch.testing.assert_close(out.double(), w[0], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(lse.double(), w[1], rtol=2e-5, atol=2e-5)
    for got, want in zip((dq, dk, dv), w[2:]):
        torch.testing.assert_close(got.double(), want, rtol=2e-4,
                                   atol=2e-4)


def test_a_ring_of_one_is_b1_bit_for_bit():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import context_parallel as cp

    q, k, v = _qkv()
    out, lse = cp.ring_in_process(q, k, v, 1, True)
    ro, rl = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    assert torch.equal(out, ro) and torch.equal(lse, rl)
    do = torch.randn_like(out)
    got = cp.ring_in_process_bwd(q, k, v, out, lse, do, 1, True)
    want = fa.flash_attention_bwd(q, k, v, ro, rl, do, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("causal", [False, True])
def test_the_ring_runs_n_n_plus_1_over_2_causal_blocks(monkeypatch, causal):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import context_parallel as cp

    calls = []
    real = fa.flash_attention

    def counted(*a, **kw):
        calls.append(kw.get("causal"))
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention", counted)
    q, k, v = _qkv(s=32)
    cp.ring_in_process(q, k, v, 4, causal)
    assert len(calls) == (10 if causal else 16)
    assert calls.count(True) == (4 if causal else 0)


def test_a_block_that_sees_no_key_weighs_zero():
    """B1 drops a masked key by the mask value, and a walk that saw no
    key leaves lse -inf: the merge weighs either block by 0 and never
    forms -inf - -inf."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import context_parallel as cp

    o1, o2 = torch.randn(1, 1, 3, 4), torch.randn(1, 1, 3, 4)
    l1 = torch.tensor([[[0.5, -float("inf"), fa.DEFAULT_MASK_VALUE]]])
    l2 = torch.tensor([[[-float("inf"), 1.5, -float("inf")]]])
    out, lse = cp.merge_blocks(cp.merge_blocks(None, (o1, l1)), (o2, l2))
    assert torch.equal(out[..., 0, :], o1[..., 0, :])
    assert torch.equal(out[..., 1, :], o2[..., 1, :])
    assert torch.equal(lse[..., :2], torch.tensor([[[0.5, 1.5]]]))
    # a row no block saw: out 0, lse -inf, nothing NaN
    out, lse = cp.merge_blocks((o1, l2), (o2, l2.clone().fill_(
        -float("inf"))))
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    assert bool((out[..., 0, :] == 0).all())
    assert lse[0, 0, 0] == -float("inf")


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
