"""paddle_tpu_torch stands alone: no jax, nothing of paddle_tpu, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, f) for f in (
        "chip_smoke.py", "lstm_breakdown.py", "lstm_grad_check.py")]
    for root, _, files in os.walk(PORT):
        out.extend(os.path.join(root, f) for f in files if f.endswith(".py"))
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_import_leaves_jax_and_paddle_tpu_out():
    # a subprocess: this test process already imported jax (conftest)
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.models.transformer\n"
        "import paddle_tpu_torch.models.stacked_lstm\n"
        "import paddle_tpu_torch.models.lenet\n"
        "import paddle_tpu_torch.kernels.lstm_cell\n"
        "import paddle_tpu_torch.kernels.gru_cell\n"
        "import paddle_tpu_torch.models.seq2seq\n"
        "import paddle_tpu_torch.serving, paddle_tpu_torch.interop\n"
        "import paddle_tpu_torch.kernels._build\n"
        "import paddle_tpu_torch.models.resnet, paddle_tpu_torch.nets\n"
        "import paddle_tpu_torch.kernels.bn_grad\n"
        "import paddle_tpu_torch.kernels.conv1x1_bwd\n"
        "import paddle_tpu_torch.passes.layout, paddle_tpu_torch.flags\n"
        "import paddle_tpu_torch.guard, paddle_tpu_torch.fault\n"
        "import paddle_tpu_torch.telemetry\n"
        "import paddle_tpu_torch.io, paddle_tpu_torch.tracing\n"
        "import paddle_tpu_torch.distributed.rpc\n"
        "import paddle_tpu_torch.serving.server, paddle_tpu_torch.cli\n"
        "import paddle_tpu_torch.models.srl\n"
        "import paddle_tpu_torch.ops.crf_ops\n"
        "import paddle_tpu_torch.ops.detection_ops\n"
        "import paddle_tpu_torch.layers.math_op_patch\n"
        "import paddle_tpu_torch.metrics, paddle_tpu_torch.average\n"
        "import paddle_tpu_torch.evaluator, paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.v2 as paddle\n"
        "import paddle_tpu_torch.reader, paddle_tpu_torch.dataset\n"
        "import paddle_tpu_torch.dataset.common\n"
        "import paddle_tpu_torch.analysis.cost\n"
        "import paddle_tpu_torch.analysis.effects\n"
        "import paddle_tpu_torch.core.debug\n"
        "import paddle_tpu_torch.core.lod_tensor\n"
        "import paddle_tpu_torch.inference_transpiler\n"
        "import paddle_tpu_torch.layout_transpiler\n"
        "import paddle_tpu_torch.memory_optimize\n"
        "import paddle_tpu_torch.parallel.comm_audit\n"
        "from paddle_tpu_torch.parallel import (collectives, distribute, "
        "mesh, parallel_executor)\n"
        "from paddle_tpu_torch.parallel import pipeline, expert_parallel\n"
        "import paddle_tpu_torch.layers.pipeline\n"
        "import paddle_tpu_torch.ops.pipeline_ops\n"
        "import paddle_tpu_torch.native, paddle_tpu_torch.recordio_writer\n"
        "from paddle_tpu_torch.distributed import (checkpoint, "
        "sharded_checkpoint, recovery, membership, master, pserver)\n"
        "assert paddle_tpu_torch.op_registry is "
        "paddle_tpu_torch.core.registry\n"
        "assert paddle.reader is paddle_tpu_torch.reader\n"
        "assert paddle.dataset is paddle_tpu_torch.dataset\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [m for m in sys.modules if m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_jax_or_the_jax_package(path):
    for mod in _imported_modules(path):
        assert not re.search(r"\bpaddle_tpu\b(?!_torch)", mod), (path, mod)
        assert not re.match(r"(jax|jaxlib)\b", mod), (path, mod)


def test_executor_without_place_needs_a_card():
    import paddle_tpu_torch as fluid

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: Executor() runs on it")
    with pytest.raises(RuntimeError, match="CPUPlace"):
        fluid.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fluid.Executor(fluid.CUDAPlace(0))
    assert fluid.Executor(fluid.CPUPlace()).device.type == "cpu"


def test_decode_engine_without_place_needs_a_card():
    from paddle_tpu_torch.models.transformer import (
        build_transformer_decode)
    from paddle_tpu_torch.serving import DecodeEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: DecodeEngine runs on it")
    pre, dec, meta = build_transformer_decode(
        vocab_size=11, d_model=8, num_layers=1, num_heads=2, max_len=16)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        DecodeEngine(pre, dec, meta, num_slots=1, prompt_buckets=(8,))


def test_restore_without_place_needs_a_card(tmp_path):
    """A restore puts a value the scope does not hold on ``place``,
    ``CUDAPlace(0)`` by default: with no card it raises."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed.sharded_checkpoint import (
        load_sharded_checkpoint, save_sharded_checkpoint)

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the restore lands on it")
    scope = fluid.Scope()
    scope.set_var("w", torch.ones(3))
    save_sharded_checkpoint(str(tmp_path), 1, scope, names=["w"])
    with pytest.raises(RuntimeError, match="CPUPlace"):
        load_sharded_checkpoint(str(tmp_path), fluid.Scope(), {})
    s = fluid.Scope()
    load_sharded_checkpoint(str(tmp_path), s, {}, place=fluid.CPUPlace())
    assert s.find_var("w").device.type == "cpu"


def test_native_builds_its_own_library_or_raises(monkeypatch, tmp_path):
    """The host runtime builds into build/torch_native/ (never the JAX
    package's native/build/); a failing build raises with the
    compiler's output."""
    from paddle_tpu_torch import native

    assert native.BUILD_DIR == os.path.join(REPO, "build", "torch_native")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "SO", str(tmp_path / "libptnative.so"))
    monkeypatch.setattr(native, "CXX_FLAGS", ("-O2", "-fno-such-flag"))
    with pytest.raises(RuntimeError, match="no-such-flag"):
        native.num_records(str(tmp_path / "x.rio"))
    assert not os.listdir(str(tmp_path))


def test_kernel_build_needs_nvcc(monkeypatch):
    from paddle_tpu_torch.kernels import _build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_attention")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_all()
    assert not _build._libs



def test_a_failed_build_raises_with_the_compilers_message(monkeypatch,
                                                          tmp_path):
    """A source that does not compile (here a shared header it includes
    is missing) raises with nvcc's own message; nothing is loaded and no
    other kernel takes its place."""
    from paddle_tpu_torch.kernels import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'flash_attention.cu: fatal error: "
                    "hopper.cuh: No such file or directory' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="(?s)nvcc failed for "
                       "csrc/flash_attention.cu.*hopper.cuh: No such file"):
        _build.load("flash_attention")
    assert not _build._libs
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())
