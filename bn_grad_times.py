"""The batch-norm backward kernel (B7) timed at ResNet-50's nine shapes on
one NVIDIA GPU.

    python3 bn_grad_times.py                     # this checkout's kernel
    python3 bn_grad_times.py --root DIR          # the checkout at DIR's
    python3 bn_grad_times.py --dtype float32     # config A (default both)

For each of the 53 batch norms of a ResNet-50 step at batch 64 (nine
distinct [N, H, W, C] shapes, channels last), in float32 (config A) and
bfloat16 (config C): the kernel's time with the 50 MB L2 flushed before
each call (a 256 MB write) and warm, beside ``torch.ops.aten.
native_batch_norm_backward`` on the same inputs (channels last, from the
saved mean and inverse standard deviation: dx, dscale and dbias in one
call, L2 flushed), the one-pass bound (x and dy read once, dx written
once, at 3.35 TB/s) and, where the checkout's wrapper has a ``plan``,
its floor (``hbm_bytes``), then the sums over a step; first, the rates
of PyTorch's own read, write and copy of 256 MB. Times are medians
of CUDA events bracketing one call behind a spin kernel, as
``chip_smoke.py`` takes them.

To compare two checkouts, run them in one call on one card, in turns
(parent, change, change, parent): ``--root`` imports
``paddle_tpu_torch`` from DIR, whose kernels build into DIR's own
``build/``. The last line is a JSON object of the rows.
"""

import argparse
import json
import os
import subprocess
import sys

# (shape, launches a step): ResNet-50 at batch 64, 224x224
SHAPES = (((64, 112, 112, 64), 1), ((64, 56, 56, 64), 6),
          ((64, 56, 56, 256), 4), ((64, 28, 28, 128), 8),
          ((64, 28, 28, 512), 5), ((64, 14, 14, 256), 12),
          ((64, 14, 14, 1024), 7), ((64, 7, 7, 512), 6),
          ((64, 7, 7, 2048), 4))
HBM_BYTES_PER_S = 3.35e12
EPS = 1e-5


def time_ms(torch, fn, reps, flush=None):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="the checkout whose paddle_tpu_torch to time")
    ap.add_argument("--dtype", choices=("float32", "bfloat16", "both"),
                    default="both")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bn_grad_times.py: no CUDA card")
    from paddle_tpu_torch.kernels import bn_grad as kbn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("card: %s; kernel from %s" % (card, os.path.abspath(
        kbn.__file__)), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(args.seed)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.zero_()

    # the card's streaming rates through PyTorch's own kernels, a yardstick
    # for the kernel's: a 256 MB read (a sum), write (zero_) and copy
    flush_sum = torch.empty((), device=dev)
    flush_to = torch.empty_like(flush_buf)
    nbytes = flush_buf.numel() * 4
    for what, fn, moved in (
            ("read", lambda: torch.sum(flush_buf, dim=0, out=flush_sum),
             nbytes),
            ("write", lambda: flush_buf.zero_(), nbytes),
            ("copy", lambda: flush_to.copy_(flush_buf), 2 * nbytes)):
        t = time_ms(torch, fn, args.reps)
        print("torch %s of 256 MB: %.6f ms, %.3f TB/s" % (
            what, t, moved / t / 1e9), flush=True)
    del flush_to

    dtypes = {"float32": (torch.float32,), "bfloat16": (torch.bfloat16,),
              "both": (torch.float32, torch.bfloat16)}[args.dtype]
    rows = []
    for dtype in dtypes:
        for shape, per_step in SHAPES:
            n, h, w, c = shape
            m = n * h * w
            x = (torch.randn(*shape, generator=g) * 1.5 + 0.7).to(dtype) \
                .to(dev)
            dy = torch.randn(*shape, generator=g).to(dtype).to(dev)
            sc = (torch.rand(c, generator=g) + 0.5).to(dev)
            xf = x.float().reshape(m, c)
            mean = xf.mean(0)
            invstd = torch.rsqrt(xf.var(0, unbiased=False) + EPS)
            del xf
            xr, dyr = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)

            def kernel():
                kbn.bn_grad(x, dy, sc, EPS)

            def library():
                torch.ops.aten.native_batch_norm_backward(
                    dyr, xr, sc, None, None, mean, invstd, True, EPS,
                    [True, True, True])

            elt = x.element_size()
            one_pass = 3 * m * c * elt + 12 * c
            row = dict(dtype=str(dtype).split(".")[-1], shape=list(shape),
                       per_step=per_step,
                       ms=time_ms(torch, kernel, args.reps, flush),
                       warm_ms=time_ms(torch, kernel, args.reps),
                       library_ms=time_ms(torch, library, args.reps, flush),
                       bound_ms=one_pass / HBM_BYTES_PER_S * 1e3)
            if hasattr(kbn, "plan"):
                pl = kbn.plan(m, c, dtype, True,
                              torch.cuda.get_device_properties(
                                  dev).multi_processor_count)
                row["floor_ms"] = pl.hbm_bytes / HBM_BYTES_PER_S * 1e3
                row["plan"] = "%s W %d G %d R %d BR %d S %d" % (
                    pl.loader, pl.width, pl.groups, pl.slabs, pl.tile_rows,
                    pl.slots)
            print("b7 %s %s x%d: flushed %.6f ms, warm %.6f ms, "
                  "native_batch_norm_backward %.6f ms, one-pass bound %.6f "
                  "ms%s" % (row["dtype"], shape, per_step, row["ms"],
                            row["warm_ms"], row["library_ms"],
                            row["bound_ms"],
                            ", plan floor %.6f ms (%s)" % (
                                row["floor_ms"], row["plan"])
                            if "floor_ms" in row else ""), flush=True)
            rows.append(row)
            del x, dy, xr, dyr
    for dt in sorted({r["dtype"] for r in rows}):
        rs = [r for r in rows if r["dtype"] == dt]
        tot = {k: sum(r["per_step"] * r[k] for r in rs)
               for k in ("ms", "warm_ms", "library_ms", "bound_ms")
               + (("floor_ms",) if "floor_ms" in rs[0] else ())}
        print("b7 %s a step (53 launches): %s" % (dt, ", ".join(
            "%s %.3f" % kv for kv in tot.items())), flush=True)
    print(json.dumps({"card": card, "root": os.path.abspath(args.root),
                      "rows": rows}))


if __name__ == "__main__":
    main()
