"""Where a step of the LSTM kernels (B3, B4) goes, on one NVIDIA GPU.

    python3 lstm_breakdown.py

Builds variants of ``paddle_tpu_torch/csrc/lstm_cell.cu`` with one part
of the step switched off, and times each at [64, T, 512], every step
valid, at T = 8 and T = 80: (t80 - t8) / 72 is the cost of one step.
A variant's results are wrong by design; only its time is read. The
variants:

* ``nowait``: the wait for the other blocks' exchange is skipped;
* ``nomma``: the tensor-core product is skipped;
* ``nocell``: B3's cell update is skipped (with ``nowait`` and
  ``nomma``);
* ``nofence``: the release fence before a block's counter is skipped.

The difference of a variant's step from the kernels' own is what that
part costs on the step's chain. Needs a card and ``nvcc``; builds into
``build/lstm_breakdown/``.
"""

import ctypes
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import lstm_cell as lc  # noqa: E402

FENCE = "  __threadfence();\n  atomicAdd(counter, 1u);"
EDITS = {
    "nowait": [("if (v >= target) return;", "return;")],
    "nomma": [("    if (steps)\n      stage_mma<NT>(slot,",
               "    if (0)\n      stage_mma<NT>(slot,")],
    "nocell": [("      if (live) {\n        float gsum[4];",
                "      if (0) {\n        float gsum[4];")],
    "nofence": [(FENCE, "  atomicAdd(counter, 1u);")],
}
VARIANTS = {"kernels": [], "nowait": ["nowait"], "nomma": ["nomma"],
            "nowait+nomma": ["nowait", "nomma"],
            "nowait+nomma+nocell": ["nowait", "nomma", "nocell"],
            "nofence": ["nofence"]}
B, H, T_SHORT, T_LONG = 64, 512, 8, 80


def build(out_dir):
    src = open(os.path.join(_build.CSRC, "lstm_cell.cu")).read()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for e in edits:
            for old, new in EDITS[e]:
                if old not in text:
                    raise SystemExit("lstm_breakdown: %r not in the source"
                                     % old)
                text = text.replace(old, new)
        cu = os.path.join(out_dir, "%d.cu" % len(procs))
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, "%d.so" % len(procs))
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
             lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit("lstm_breakdown: %s did not build:\n%s"
                             % (name, log))
        so = ctypes.CDLL(lib)
        for fn, (argtypes, restype) in _build.SOURCES["lstm_cell"].items():
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = restype
        libs[name] = so
    return libs


def time_ms(fn, reps=15):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("lstm_breakdown: no CUDA device")
    dev = torch.device("cuda", 0)
    out_dir = os.path.join(REPO, "build", "lstm_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    libs = build(out_dir)
    g = torch.Generator().manual_seed(0)
    inputs = {}
    for T in (T_SHORT, T_LONG):
        xg = torch.randn(B, T, 4 * H, generator=g) * 0.5
        w = torch.randn(H, 4 * H, generator=g) * H ** -0.5
        h0, c0 = (torch.randn(B, H, generator=g) * 0.1 for _ in range(2))
        p = torch.randn(3, H, generator=g) * 0.1
        dhs, dcs = (torch.randn(B, T, H, generator=g) for _ in range(2))
        inputs[T] = [t.to(dev) for t in (xg, w, h0, c0, torch.ones(B, T), p,
                                         dhs, dcs)]
    for name, lib in libs.items():
        _build._libs["lstm_cell"] = lib
        ms = {}
        for T, (xg, w, h0, c0, mask, p, dhs, dcs) in inputs.items():
            _, cs, st = lc.lstm_forward(xg, w, h0, c0, mask, p)
            ms["fwd", T] = time_ms(
                lambda: lc.lstm_forward(xg, w, h0, c0, mask, p))
            ms["bwd", T] = time_ms(
                lambda: lc.lstm_backward(st, cs, w, p, c0, mask, dhs, dcs))
        print("%-20s " % name + " | ".join(
            "%s %.4f ms at T=%d, %.4f at T=%d: %.3f us a step" % (
                k, ms[k, T_LONG], T_LONG, ms[k, T_SHORT], T_SHORT,
                (ms[k, T_LONG] - ms[k, T_SHORT]) * 1e3 / (T_LONG - T_SHORT))
            for k in ("fwd", "bwd")), flush=True)
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
