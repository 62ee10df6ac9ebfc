"""``python -m paddle_tpu_torch <cmd>`` — the command-line dispatcher.

Capability parity: the JAX package's ``cli.py``, for these commands:

  serve        bucketed one-shot inference server over a saved
               inference model (``io.save_inference_model``): one CUDA
               graph per batch bucket, dynamic batching, the line-JSON
               RPC front-end
  version      print version info

``serve`` runs on the card; ``--place cpu`` asks for the CPU (the tests
do). One replica only: ``--replicas`` above 1, ``--deploy-dir``,
``--aot-cache`` and ``--membership`` exit with code 2 and name the
ROADMAP.md item (Queue 1) that brings them. ``train``, ``bench``,
``master``, ``pserver`` and ``merge_model`` are not ported yet.
"""

import argparse
import json
import signal as _signal
import sys
import threading

__version__ = "0.2.0"

# ROADMAP.md Queue 1 items that bring what ``serve`` refuses
_NOT_PORTED = {
    "replicas": "--replicas > 1 needs the router tier (serving/router.py, "
                "ROADMAP.md Queue 1 item 10)",
    "deploy_dir": "--deploy-dir needs deploy/ (ROADMAP.md Queue 1 item 10)",
    "aot_cache": "--aot-cache needs serving/aot_cache.py (ROADMAP.md "
                 "Queue 1 item 10)",
    "membership": "--membership needs distributed/membership.py "
                  "(ROADMAP.md Queue 1 item 8)",
}


def _die_with_parent(sig=_signal.SIGTERM):
    """Best-effort orphan prevention for script-spawned children
    (``serve --die-with-parent``): on Linux, PR_SET_PDEATHSIG delivers
    ``sig`` to THIS process the moment its parent dies, so a killed
    test run cannot strand a ``serve`` process. No-op where prctl is
    unavailable. Returns True once armed."""
    import ctypes
    import os

    try:
        libc = ctypes.CDLL(None, use_errno=True)
        PR_SET_PDEATHSIG = 1
        if libc.prctl(PR_SET_PDEATHSIG, int(sig), 0, 0, 0) != 0:
            return False
    except (OSError, AttributeError, TypeError):
        return False
    if os.getppid() == 1:
        # the parent ALREADY died between fork and here; the signal
        # only fires on FUTURE deaths, so honor the contract now
        os._exit(1)
    return True


def _interrupt_event():
    """Install SIGINT/SIGTERM handlers NOW (before the service announces
    itself — a client may signal the instant it sees the endpoint line)
    and return the Event they set."""
    stop = threading.Event()
    for sig in (_signal.SIGINT, _signal.SIGTERM):
        _signal.signal(sig, lambda *a: stop.set())
    return stop


def _drain_with_retries(server, what="drain"):
    for _ in range(3):
        try:
            server.drain()
            return 0
        except RuntimeError as e:
            # admitted requests still flushing past the drain timeout:
            # retry — exiting would strand them
            print("%s: %s" % (what, e), flush=True)
    print("%s gave up after 3 attempts; exiting" % what, flush=True)
    return 1


def cmd_serve(args):
    """Serve a saved inference model: capture every batch bucket ahead
    of time, coalesce concurrent requests in the dynamic batcher, answer
    over the line-JSON RPC channel. SIGTERM/SIGINT drain gracefully —
    readiness flips false, admitted requests flush, then the listener
    closes and the process exits 0.

    A float32 model is served in float32: the process turns TF32 off for
    cuDNN's convolutions and for matmuls (PyTorch turns cuDNN's on by
    default), so its answers are those of an in-process engine with TF32
    off, the setting the port's card checks hold it to."""
    refused = [msg for key, msg in _NOT_PORTED.items()
               if (args.replicas > 1 if key == "replicas"
                   else getattr(args, key))]
    if refused:
        for msg in refused:
            print("serve: %s, which is not ported" % msg, flush=True)
        return 2
    if not args.model_dir:
        print("serve: need --model-dir", flush=True)
        return 2

    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import fault
    from paddle_tpu_torch.serving import ServingEngine, ServingServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.telemetry:
        fluid.telemetry.enable()
    if args.die_with_parent:
        _die_with_parent()
    for spec in args.inject or ():
        # in-process chaos seams for THIS replica, e.g.
        # '{"site": "serving.batch", "delay_ms": [40, 80]}'
        doc = dict(json.loads(spec))
        fault.inject(doc.pop("site"), **doc)
    stop = _interrupt_event()
    place = fluid.CPUPlace() if args.place == "cpu" else fluid.CUDAPlace(0)
    exe = fluid.Executor(place)
    program, feed_names, fetch_vars = fluid.io.load_inference_model(
        args.model_dir, exe)
    fetch_names = [v.name for v in fetch_vars]
    engine = ServingEngine(program, feed_names, fetch_names,
                           max_batch=args.max_batch,
                           quantize=args.quantize or None, place=place)
    server = ServingServer(engine, address=(args.host, args.port),
                           max_delay_ms=args.max_delay_ms,
                           max_queue=args.max_queue)
    server.start(warmup=True)  # ready only after every bucket is built
    print("serving listening on %s:%d (buckets=%s, max_queue=%d, "
          "device=%s)" % (server.address[0], server.address[1],
                          list(engine.buckets), args.max_queue,
                          engine.device), flush=True)
    stop.wait()
    return _drain_with_retries(server)


def cmd_version(args):
    import torch

    devices = (["cuda:%d %s" % (i, torch.cuda.get_device_name(i))
                for i in range(torch.cuda.device_count())]
               if torch.cuda.is_available() else ["cpu"])
    print("paddle_tpu_torch %s (torch %s, cuda %s, devices: %s)"
          % (__version__, torch.__version__, torch.version.cuda,
             ", ".join(devices)))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="paddle_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("serve")
    p.add_argument("--model-dir", default="",
                   help="save_inference_model output directory")
    p.add_argument("--deploy-dir", default="",
                   help="not ported (ROADMAP.md Queue 1 item 10)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--place", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU")
    p.add_argument("--max-batch", type=int, default=8,
                   help="largest batch bucket (buckets: 1/2/4/.../max)")
    p.add_argument("--max-delay-ms", type=float, default=5.0,
                   help="batcher coalescing window")
    p.add_argument("--max-queue", type=int, default=128,
                   help="admission-queue bound; past it requests are "
                        "rejected with Overloaded (load shedding)")
    p.add_argument("--replicas", type=int, default=1,
                   help="1 only: more need the router tier (ROADMAP.md "
                        "Queue 1 item 10)")
    p.add_argument("--aot-cache", default="",
                   help="not ported (ROADMAP.md Queue 1 item 10)")
    p.add_argument("--telemetry", action="store_true",
                   help="enable the runtime telemetry registry")
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="per-tensor int8 weight quantization (symmetric "
                        "absmax), dequantized inside each bucket's graph")
    p.add_argument("--membership", default="",
                   help="not ported (ROADMAP.md Queue 1 item 8)")
    p.add_argument("--die-with-parent", action="store_true",
                   help="arm PDEATHSIG so this process dies with its "
                        "spawner (Linux)")
    p.add_argument("--inject", action="append", default=[],
                   metavar="JSON",
                   help="install a fault rule in this process, e.g. "
                        "'{\"site\": \"serving.batch\", \"delay_ms\": "
                        "[40, 80]}'; repeatable")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("version")
    p.set_defaults(fn=cmd_version)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
