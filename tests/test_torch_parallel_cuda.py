"""ParallelExecutor on the card: NCCL at world 1.

NCCL refuses two ranks of one communicator on one card, so the card runs
the data-parallel path at world 1, where every bucket, all-to-all,
all-gather and quantized exchange is real and each sum over the ranks
has its one addend (tests/test_torch_parallel.py holds the sums across
ranks at gloo worlds of 2, 3 and 4 on the CPU). Here, on tests/
test_comm.py's MLP: the bucketed exchange is bitwise the per-gradient
one (the global view) and the plain ``Executor``; ZeRO-1 is bitwise
zero_stage 0 for SGD, Momentum and Adam; a ``run_chunk`` of graph
replays, its collectives captured, is bitwise the eager steps, with the
census of the captured step holding one exchange a bucket; the int8 and
fp8 exchanges train.

The tensor and sequence axes at world 1 (tests/test_torch_tensor_
parallel.py and tests/test_torch_context_parallel.py hold the sums
across ranks on the CPU): the dyadic Megatron MLP under a ``(1, 1)``
('dp', 'mp') mesh is the plain ``Executor`` bit for bit, and so is its
run_chunk of graph replays with the mp collectives captured; the small
transformer under bf16 AMP with ``mp=True`` and with ``seq_axis='sp'``
(the global view over a ``(1, 1)`` ('dp', 'sp') mesh) is the plain step
bit for bit with the program's bf16 B1 launches; the ring's blocks at 4
chunks (``ring_in_process``) launch B1 10 times causal and hold against
B1 over the whole sequence and the plain ring.

Marked ``cuda``: each test skips inside itself where torch finds no
card. This file imports torch and the port only (the machine with the
card has no jax), so run it there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.data_feeder import stack_feeds

import test_torch_parallel as tp


@pytest.fixture(scope="module")
def nccl():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import socket

    import torch.distributed as dist

    from paddle_tpu_torch.parallel.distribute import init_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    init_multihost("localhost:%d" % port, 1, 0,
                   device=torch.device("cuda", 0), timeout_s=120)
    try:
        yield torch.device("cuda", 0)
    finally:
        dist.destroy_process_group()


def _train(kind, comm=None, zero=0, plain=False, chunk=False):
    """3 steps of a builder from its startup on the card: (losses, state
    as flat numpy, the executor)."""
    from paddle_tpu_torch.parallel import CommConfig, ParallelExecutor

    prog, startup, loss = tp.build(fluid, kind)
    startup.random_seed = 0
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    fs = tp.feeds("dense")
    if plain:
        exe = fluid.Executor()
        losses = [exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0]
                  for f in fs]
    else:
        exe = ParallelExecutor(loss_name=loss.name, main_program=prog,
                               zero_stage=zero,
                               comm_config=None if comm is None
                               else CommConfig(**comm))
        if chunk:
            losses = list(exe.run_chunk(prog, feed_chunk=stack_feeds(fs),
                                        fetch_list=[loss], scope=scope)[0])
        else:
            losses = [exe.run(feed=f, fetch_list=[loss], scope=scope)[0]
                      for f in fs]
    state = {n: t.detach().as_subclass(torch.Tensor).reshape(-1).cpu()
             .numpy() for n, t in scope.vars.items()}
    return losses, state, exe


def _bitwise(a, b, what):
    la, sa, _ = a
    lb, sb, _ = b
    assert [np.asarray(x).tobytes() for x in la] == \
        [np.asarray(x).tobytes() for x in lb], what
    for n in sb:
        if n.startswith("comm@"):
            continue
        assert sa[n].tobytes() == sb[n].tobytes(), (what, n)


@pytest.mark.cuda
def test_bucketed_is_the_per_gradient_exchange(nccl):
    plain = _train("mlp", plain=True)
    per_grad = _train("mlp", zero=0)
    bucketed = _train("mlp", comm=dict(bucket_mb=0.05))
    _bitwise(per_grad, plain, "global view vs Executor")
    _bitwise(bucketed, per_grad, "bucketed vs per-gradient")
    plan = bucketed[2]._comm_plans[next(iter(bucketed[2]._comm_plans))]
    assert len(plan.buckets) >= 3
    assert bucketed[2].last_census.count("bucket") == 2 * len(plan.buckets)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mlp_sgd", "mlp_momentum", "mlp"])
def test_zero1_is_zero0(nccl, kind):
    _bitwise(_train(kind, comm=dict(bucket_mb=0.05, zero_stage=1)),
             _train(kind, comm=dict(bucket_mb=0.05)), kind)
    _bitwise(_train(kind, zero=1), _train(kind, zero=0), kind + " global")


@pytest.mark.cuda
@pytest.mark.parametrize("comm", [dict(bucket_mb=0.05),
                                  dict(bucket_mb=0.05, zero_stage=1)],
                         ids=["bucketed", "zero1"])
def test_graph_chunk_is_the_eager_steps(nccl, comm):
    eager = _train("mlp", comm=comm)
    graph = _train("mlp", comm=comm, chunk=True)
    _bitwise(graph, eager, "graph replays vs eager")
    pe = graph[2]
    plan = pe._comm_plans[next(iter(pe._comm_plans))]
    per_bucket = 1 if comm.get("zero_stage") else 2
    assert pe.last_census.count("bucket") == per_bucket * len(plan.buckets)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_exchange_trains(nccl, mode):
    losses, state, pe = _train("mlp", comm=dict(bucket_mb=0.05,
                                                quantize=mode))
    assert np.isfinite(np.asarray(losses, np.float64)).all()
    assert any(n.startswith("comm@ef") for n in state)
    assert pe.last_census.count("bucket") > 0


# ---- the tensor and sequence axes at world 1 ----

def _mp_mlp(plain=False, chunk=False):
    """3 SGD steps of the dyadic Megatron MLP on the card: (losses,
    state, executor)."""
    import test_torch_tensor_parallel as ttp
    from paddle_tpu_torch.parallel import (CommConfig, ParallelExecutor,
                                           make_mesh)

    prog, startup, loss = ttp.build_mlp(fluid, True)
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    init = ttp.dyadic({n: tuple(scope.find_var(n).shape)
                       for n in ttp.WEIGHTS})
    for n, v in init.items():
        scope.set_var(n, torch.from_numpy(v).cuda())
    fs = [ttp.mlp_feed(i) for i in range(ttp.MLP_STEPS)]
    if plain:
        exe = fluid.Executor()
        losses = [exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0]
                  for f in fs]
    else:
        exe = ParallelExecutor(loss_name=loss.name, main_program=prog,
                               mesh=make_mesh((1, 1), ("dp", "mp")),
                               zero_stage=0, comm_config=CommConfig())
        if chunk:
            losses = list(exe.run_chunk(prog, feed_chunk=stack_feeds(fs),
                                        fetch_list=[loss], scope=scope)[0])
        else:
            losses = [exe.run(feed=f, fetch_list=[loss], scope=scope)[0]
                      for f in fs]
    state = {n: t.detach().reshape(-1).cpu().numpy()
             for n, t in scope.vars.items()}
    return losses, state, exe


@pytest.mark.cuda
def test_mp_at_one_rank_is_the_plain_step(nccl):
    plain = _mp_mlp(plain=True)
    mp = _mp_mlp()
    _bitwise(mp, plain, "mp vs Executor")
    tags = [r["tag"] for r in mp[2].last_census.records
            if r["axis"] == "mp"]
    assert tags.count("mp.fwd_row") == 1
    assert tags.count("mp.param") == 3
    _bitwise(_mp_mlp(chunk=True), mp, "mp graph replays vs eager")


def _small_lm(fl_kw, parallel):
    """2 steps of the small transformer under bf16 AMP on the card:
    (losses, state, bf16 B1 launches)."""
    import test_torch_tensor_parallel as ttp
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import (CommConfig, ParallelExecutor,
                                           make_mesh)

    prog, startup, loss = ttp.build_tfm(fluid, **fl_kw)
    fluid.amp.enable(prog)
    startup.random_seed = 1
    scope = fluid.Scope()
    fluid.Executor().run(startup, scope=scope)
    if not parallel:
        exe = fluid.Executor()
    elif "mp" in fl_kw:
        exe = ParallelExecutor(loss_name=loss.name, main_program=prog,
                               mesh=make_mesh((1, 1), ("dp", "mp")),
                               zero_stage=0, comm_config=CommConfig())
    else:
        exe = ParallelExecutor(loss_name=loss.name, main_program=prog,
                               mesh=make_mesh((1, 1), ("dp", "sp")),
                               seq_axis="sp")
    fa.reset_launches()
    losses = [exe.run(program=prog, feed=ttp.tfm_feed(i),
                      fetch_list=[loss], scope=scope)[0] for i in range(2)]
    torch.cuda.synchronize()
    state = {n: t.detach().as_subclass(torch.Tensor).reshape(-1).cpu()
             .float().numpy() for n, t in scope.vars.items()}
    return losses, state, dict(fa.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(mp=True), dict(seq_axis="sp")],
                         ids=["mp", "sp"])
def test_transformer_axes_at_one_rank_are_the_plain_step(nccl, kw):
    import test_torch_tensor_parallel as ttp

    got, want = _small_lm(kw, True), _small_lm(kw, False)
    _bitwise(got, want, "parallel vs Executor")
    # each fused_attention and its grad launch the bf16 B1 once a step
    assert got[2]["flash_attention_bf16"] == 2 * 2 * ttp.NL
    assert got[2] == want[2]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_ring_blocks_on_the_card(nccl, dtype):
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.parallel import context_parallel as cp

    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 4, 256, 64, generator=g).to(dtype)
                   .cuda() for _ in range(4))
    ids = (torch.arange(256)[None, :] >= 100).to(torch.int32) \
        .expand(2, 256).contiguous().cuda()
    key = "flash_attention_bf16" if dtype == torch.bfloat16 \
        else "flash_attention"
    n0 = fa.launches[key]
    out, lse = cp.ring_in_process(q, k, v, 4, True, segment_ids=(ids, ids))
    assert fa.launches[key] - n0 == 10
    po, pl_ = cp.ring_in_process(q, k, v, 4, True, segment_ids=(ids, ids),
                                 plain=True)
    wo, wl = fa.flash_attention(q, k, v, causal=True,
                                segment_ids=(ids, ids), return_lse=True)
    tol = dict(rtol=2e-2, atol=8e-3) if dtype == torch.bfloat16 \
        else dict(rtol=1e-4, atol=1e-5)
    for want in (po, wo):
        torch.testing.assert_close(out.float(), want.float(), **tol)
    torch.testing.assert_close(lse, wl, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, pl_, rtol=1e-5, atol=1e-5)
    dq, dk, dv = cp.ring_in_process_bwd(q, k, v, out, lse, do, 4, True,
                                        segment_ids=(ids, ids))
    wq, wk, wv = fa.flash_attention_bwd(q, k, v, wo, wl, do, True, None,
                                        (ids, ids))
    scale = max(float(t.abs().max()) for t in (wq, wk, wv))
    for a, b in ((dq, wq), (dk, wk), (dv, wv)):
        torch.testing.assert_close(a.float(), b.float(),
                                   rtol=tol["rtol"],
                                   atol=tol["atol"] * max(1.0, scale))
