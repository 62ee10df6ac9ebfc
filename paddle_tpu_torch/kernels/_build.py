"""Build and load the hand-written CUDA kernels of ``paddle_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers are compiled, so a build takes seconds. Libraries land in
``build/torch_kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is.

Nothing is built when a module is imported: the first CUDA tensor that
reaches a kernel wrapper calls :func:`load`; :func:`load_all` starts one
``nvcc`` per source, all at once, and waits for them together. A missing
``nvcc`` or a failed build raises; there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["SOURCES", "NVCC_FLAGS", "load", "load_all", "build_seconds"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: kernel library name -> its C entry points' ctypes signatures
#: (argtypes, restype); every pointer and the stream are c_void_p
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SOURCES = {
    "flash_attention": {
        "flash_attention_fwd": ([_P] * 7 + [_I] * 5 + [_F, _I, _P], _I),
        "flash_attention_fwd_bf16": ([_P] * 7 + [_I] * 5
                                     + [_F, _I, _I, _P], _I),
        "flash_decode": ([_P] * 5 + [_I] * 4 + [_F, _P], _I),
        "flash_decode_bf16": ([_P] * 5 + [_I] * 4 + [_F, _P], _I),
        "decode_plan": ([_I] * 6 + [_P], _I),
    },
    "lstm_cell": {
        "lstm_fwd": ([_P] * 12 + [_I] * 3 + [_P], _I),
        "lstm_fwd_bf16": ([_P] * 12 + [_I] * 3 + [_P], _I),
        "lstm_bwd": ([_P] * 15 + [_I] * 3 + [_P], _I),
        "lstm_bwd_bf16": ([_P] * 15 + [_I] * 3 + [_P], _I),
        "lstm_plan": ([_I] * 4 + [_P], _I),
    },
    "lstm_cluster": {
        "lstm_fwd_cluster": ([_P] * 9 + [_I] * 3 + [_P], _I),
        "lstm_bwd_cluster": ([_P] * 12 + [_I] * 3 + [_P], _I),
        "lstm_cluster_plan": ([_I] * 3 + [_P], _I),
    },
    "gru_cell": {
        "gru_fwd": ([_P] * 10 + [_I] * 3 + [_P], _I),
        "gru_fwd_bf16": ([_P] * 10 + [_I] * 3 + [_P], _I),
        "gru_plan": ([_I] * 5 + [_P], _I),
        "gru_bwd": ([_P] * 12 + [_I] * 3 + [_P], _I),
        "gru_bwd_bf16": ([_P] * 12 + [_I] * 3 + [_P], _I),
    },
    "gru_cluster": {
        "gru_fwd_cluster": ([_P] * 6 + [_I] * 3 + [_P], _I),
        "gru_bwd_cluster": ([_P] * 8 + [_I] * 3 + [_P], _I),
        "gru_cluster_plan": ([_I] * 3 + [_P], _I),
    },
    "bn_grad": {
        "bn_grad": ([_P] * 7 + [_I, _I, _F] + [_I] * 8 + [_P], _I),
    },
    "conv1x1_bwd": {
        "conv1x1_bwd": ([_P] * 7 + [_I] * 11 + [_P], _I),
        "conv1x1_bwd_bf16": ([_P] * 7 + [_I] * 11 + [_P], _I),
    },
}

_lock = threading.Lock()
_libs = {}
#: library name -> seconds from starting its nvcc to collecting it (an
#: upper bound on its compile time when several build at once)
build_seconds = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels of paddle_tpu_torch are built from source at first "
            "use and cannot run without the CUDA toolkit")
    return path


def _target(name):
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256()
    # the source and the headers it may include (csrc/*.cuh)
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, "lib%s-%s.so" % (
        name, h.hexdigest()[:16]))


def _start(name):
    """Start compiling ``csrc/<name>.cu`` unless its library is already
    built. Returns ``(process, tmp, out, start time)``, or None when
    built."""
    src, out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name, started):
    if started is None:
        return
    proc, tmp, out, t0 = started
    log = proc.communicate()[0]
    build_seconds[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError("nvcc failed for csrc/%s.cu (exit %d):\n%s"
                           % (name, proc.returncode, log))
    os.replace(tmp, out)   # atomic: a reader never sees half a library


def _open(name):
    _, out = _target(name)
    lib = ctypes.CDLL(out)
    for fn, (argtypes, restype) in SOURCES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _libs[name] = lib
    return lib


def load(name):
    """The loaded ctypes library of ``csrc/<name>.cu``, built first if
    needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            _open(name)
        return _libs[name]


def load_all():
    """Build every source in :data:`SOURCES` with one ``nvcc`` each, all
    started together, then load them. Returns {name: library}."""
    with _lock:
        names = [n for n in SOURCES if n not in _libs]
        started = {n: _start(n) for n in names}
        errors = []
        for n in names:
            try:
                _finish(n, started[n])
                _open(n)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return dict(_libs)
