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
