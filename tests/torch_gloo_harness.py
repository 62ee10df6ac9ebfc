"""Gloo worlds on the CPU for the port's multi-process tests.

A test file that holds a cross-rank path runs ITSELF as a script, one
process a rank (``start``): each rank joins a gloo world over a file
store (``join``), runs its scenarios and writes what it found into the
world's directory, while the test process runs the JAX package's side.
``finish`` requires every rank to exit 0 by the world's deadline and
kills any that outlives it, so no rank outlives its test.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start(script, world, d, timeout):
    """Start ``world`` ranks of ``script`` (argv: rank, world, ``d``);
    each writes its output to ``d``/rank<r>.log (a pipe left unread
    would block a rank, and with it every collective of its world)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    procs = []
    for r in range(world):
        with open(os.path.join(d, "rank%d.log" % r), "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(script), str(r),
                 str(world), d], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    return procs, time.monotonic() + timeout


def finish(started, d):
    """Every rank must exit 0 by the world's deadline; none outlives
    it."""
    procs, deadline = started
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        logs = []
        for r, _ in bad:
            with open(os.path.join(d, "rank%d.log" % r), "rb") as f:
                logs.append(f.read()[-3000:].decode(errors="replace"))
        raise AssertionError("ranks failed %s:\n%s" % (bad,
                                                        "\n".join(logs)))


def join(rank, world, d, timeout):
    """This process as rank ``rank`` of a gloo world of ``world`` over a
    file store in ``d``."""
    import torch

    torch.set_num_threads(1)
    from paddle_tpu_torch.parallel.distribute import init_multihost

    init_multihost("file://" + os.path.join(d, "store"), world, rank,
                   device="cpu", timeout_s=timeout)


def leave():
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def snapshot(scope):
    """{name: float64 numpy} of a scope's tensors, in name order (a
    ZeRO accumulator's ``np.asarray`` is a collective: every rank reads
    the same names in the same order)."""
    import numpy as np

    out = {}
    for n in sorted(scope.local_var_names()):
        v = scope.find_var(n)
        if hasattr(v, "shape"):
            a = np.asarray(v)
            out[n] = a.astype(np.float64) if a.dtype.kind in "fiub" else a
    return out
