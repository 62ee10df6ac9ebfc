"""The port takes every keyword the JAX package takes: for every public
name (``__all__``) that a module of the port and the module of the same
path in the JAX package both export, each parameter of the JAX
function, class constructor or public method is a parameter of the
port's, of the same kind and with the same default. A parameter the port
adds must have a default (or be ``*args``/``**kwargs``), so a call
written for the JAX package still works.

The differences that stay are listed by name below, each with its
reason; a difference that is not listed fails the test."""

import importlib
import importlib.util
import inspect
import os
import pkgutil

import pytest

import paddle_tpu  # noqa: F401  (the JAX package: every module compared)
import paddle_tpu_torch

# the Pallas kernels' interpreter switch and their TPU tiling: the CUDA
# kernels' tiles are fixed, and a CPU tensor runs the plain version
_PALLAS = "the Pallas interpreter switch and TPU tiling (VMEM)"
# the persistent AOT cache (serving/aot_cache.py) is not ported yet:
# ROADMAP.md Queue 1 item 7 (the router, the AOT cache and deploy)
_AOT = "the persistent AOT cache arrives with serving/aot_cache.py " \
       "(ROADMAP.md Queue 1 item 7)"

#: "module:qualname" -> {parameter: reason}, or {"*": reason} for a
#: signature that differs as a whole
DELIBERATE = {
    "serving.decode:DecodeEngine": {
        "aot_cache": _AOT},
    "serving.decode:DecodeEngine.__init__": {"aot_cache": _AOT},
    "serving.engine:ServingEngine": {"aot_cache": _AOT},
    "serving.engine:ServingEngine.__init__": {"aot_cache": _AOT},
    "serving:DecodeEngine": {"aot_cache": _AOT},
    "serving:DecodeEngine.__init__": {"aot_cache": _AOT},
    "serving:ServingEngine": {"aot_cache": _AOT},
    "serving:ServingEngine.__init__": {"aot_cache": _AOT},
    "core.debug:guard_outputs": {
        "check": "the step's NanCheck, where the port's guard records a "
                 "device-side flag a tensor; the JAX package's checkify "
                 "checks land in the traced step"},
    "core.lower:concat_time_padded": {
        "xp": "the array module defaults to the package's own: jax.numpy "
              "there, torch here (numpy in both for host arrays)"},
    "core.lower:TraceContext": {
        "*": "it carries what a run needs: the port's device and random "
             "generators, not JAX's key, mesh and comm layer"},
    "core.lower:TraceContext.__init__": {"*": "as TraceContext"},
    "core.registry:OpSpec": {
        "raw": "the JAX package's raw lowerings (control flow over the "
               "environment) have no counterpart in the eager port"},
    "core.registry:OpSpec.__init__": {"raw": "as OpSpec"},
    "passes.remat:RematPlan": {
        "fence": "XLA's optimization barrier around a replay; the eager "
                 "port replays without one"},
    "passes.remat:RematPlan.__init__": {"fence": "as RematPlan"},
    "kernels.flash_attention:flash_attention": {
        "block_q": _PALLAS, "interpret": _PALLAS},
    "kernels.flash_attention:flash_decode": {
        "block_k": _PALLAS, "interpret": _PALLAS},
    "kernels.bn_grad:bn_grad": {"interpret": _PALLAS},
    "kernels.bn_grad:supported": {"interpret": _PALLAS},
    "kernels.bn_grad:valid_tile": {"c": _PALLAS, "itemsize": _PALLAS},
    "kernels.conv1x1_bwd:supported": {"interpret": _PALLAS},
    "kernels.gru_cell:gru_sequence": {"interpret": _PALLAS},
    "kernels.lstm_cell:lstm_sequence": {"interpret": _PALLAS},
    "parallel.collectives:CommPlan.wire_bytes": {
        "mode": "the 'unset' default is each package's own sentinel "
                "object (None asks for the float32 volume in both)"},
    "parallel.mesh:P": {
        "*": "the port's partition spec is a plain tuple of axis names "
             "(jax.sharding.PartitionSpec's signature is (*args, "
             "**kwargs))"},
    "v2:init": {
        "use_gpu": "v2's executors run on the card unless asked for the "
                   "CPU: init() means CUDAPlace(0) as Executor() does; "
                   "paddle_tpu takes use_gpu=False and ignores it"},
}

#: the public names of a package whose ``__init__`` has no ``__all__``,
#: compared as if it listed them
PUBLIC = {
    "": ("Executor", "calc_gradient", "LoDTensor", "set_check_nan_inf",
         "InferenceTranspiler", "LayoutTranspiler", "memory_optimize",
         "release_memory", "is_compiled_with_cuda",
         "is_compiled_with_tpu", "append_backward", "set_flags",
         "get_flags", "ParallelExecutor", "DistributeTranspiler"),
    "v2": ("init", "infer", "batch"),
    "distributed": ("MasterServer", "MasterClient", "CheckpointManager",
                    "save_checkpoint", "load_checkpoint",
                    "latest_checkpoint", "RpcError", "RpcConnectionError",
                    "RpcTimeout", "RpcRemoteError", "CircuitOpenError",
                    "CircuitBreaker", "RpcChannel", "Preemption",
                    "RecoveryLoop", "train_with_recovery",
                    "init_multihost"),
    "parallel": ("make_mesh", "get_mesh", "mesh_guard", "ParallelExecutor",
                 "CommConfig", "DistributeTranspiler"),
    "reader": ("map_readers", "buffered", "compose", "chain", "shuffle",
               "firstn", "xmap_readers", "cache", "double_buffer",
               "super_batch", "device_chunks", "ElasticShardPlan",
               "elastic_shard", "batch"),
}


#: top-level names of the JAX package that the port does not have, each
#: with its reason: deliberate, or the ROADMAP Queue 1 item that brings it
TOP_LEVEL_ABSENT = {
    "TPUPlace": "deliberate: the port runs on CUDA cards and the CPU "
                "(CUDAPlace, CPUPlace); it has no TPU place",
    "XLAPlace": "deliberate: the port has no XLA device; CUDAPlace names "
                "the card",
    "profiler": "item 6 (observability)",
    "telemetry_export": "item 6 (observability)",
    "trace_export": "item 6 (observability)",
    "concurrency": "item 8 (concurrency.py, layers/csp.py)",
    "Go": "item 8", "Select": "item 8", "make_channel": "item 8",
    "channel_send": "item 8", "channel_recv": "item 8",
    "channel_close": "item 8",
}


def _shared_modules():
    """Relative module paths the port has and the JAX package has too."""
    out = [""]
    for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                   "paddle_tpu_torch."):
        rel = m.name[len("paddle_tpu_torch."):]
        if rel.endswith("__main__"):
            continue
        if importlib.util.find_spec("paddle_tpu." + rel) is not None:
            out.append(rel)
    return sorted(out)


def _module(pkg, rel):
    return importlib.import_module(pkg + ("." + rel if rel else ""))


def _callables(jm, tm):
    """(qualified name, JAX object, port object) of every shared public
    callable and every public method (and constructor) of a shared
    class."""
    names = set(getattr(jm, "__all__", ())) & set(getattr(tm, "__all__", ()))
    rel = tm.__name__[len("paddle_tpu_torch."):]
    names |= {n for n in PUBLIC.get(rel, ()) if hasattr(jm, n)}
    for n in sorted(names):
        a, b = getattr(jm, n, None), getattr(tm, n, None)
        if not (callable(a) and callable(b)):
            continue
        yield n, a, b
        if inspect.isclass(a) and inspect.isclass(b):
            for mn, ma in inspect.getmembers(a):
                if mn.startswith("_") and mn != "__init__":
                    continue
                mb = getattr(b, mn, None)
                if callable(ma) and callable(mb):
                    yield n + "." + mn, ma, mb


def _norm(v):
    """A default as compared: a dtype by its name (jnp.float32 and
    torch.float32 are one default)."""
    import numpy as np
    import torch

    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    if isinstance(v, type) and hasattr(v, "dtype"):
        try:
            return np.dtype(v).name
        except TypeError:
            return v
    return v


def _same_default(a, b):
    if a is inspect.Parameter.empty:
        return True             # the port may give a default the JAX
                                # package does not
    if b is inspect.Parameter.empty:
        return False
    a, b = _norm(a), _norm(b)
    try:
        return bool(a == b) and type(a) is type(b)
    except Exception:
        return repr(a) == repr(b)


def _differences(a, b):
    """{parameter: what differs} of the port's ``b`` against ``a``."""
    try:
        sa, sb = inspect.signature(a), inspect.signature(b)
    except (TypeError, ValueError):
        return {}
    pa, pb = sa.parameters, sb.parameters
    var_kw = any(p.kind == p.VAR_KEYWORD for p in pb.values())
    out = {}
    for name, p in pa.items():
        q = pb.get(name)
        if q is None:
            if not (var_kw and p.kind in (p.KEYWORD_ONLY,
                                          p.POSITIONAL_OR_KEYWORD)
                    and p.default is not p.empty):
                out[name] = "missing"
            continue
        if p.kind != q.kind and not (
                p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD)):
            out[name] = "kind %s -> %s" % (p.kind, q.kind)
        elif not _same_default(p.default, q.default):
            out[name] = "default %r -> %r" % (p.default, q.default)
    for name, q in pb.items():
        if name not in pa and q.default is q.empty and q.kind not in (
                q.VAR_POSITIONAL, q.VAR_KEYWORD, q.KEYWORD_ONLY):
            out[name] = "added without a default"
    return out


MODULES = _shared_modules()


@pytest.mark.parametrize("rel", MODULES, ids=lambda r: r or "paddle_tpu")
def test_the_port_takes_every_keyword_of_the_jax_package(rel):
    jm, tm = _module("paddle_tpu", rel), _module("paddle_tpu_torch", rel)
    found = {}
    for qual, a, b in _callables(jm, tm):
        diff = _differences(a, b)
        if diff:
            found["%s:%s" % (rel, qual)] = diff
    unlisted = {}
    for key, diff in found.items():
        listed = DELIBERATE.get(key, {})
        if "*" in listed:
            continue
        rest = {p: d for p, d in diff.items() if p not in listed}
        if rest:
            unlisted[key] = rest
    assert not unlisted, "signatures that differ from the JAX package's " \
        "and are not listed as deliberate: %s" % unlisted
    # a listed difference that went away leaves the list
    stale = [k for k in DELIBERATE if k.split(":")[0] == rel
             and k not in found]
    assert not stale, "listed as deliberate but no longer different: %s" \
        % stale


def test_the_list_names_only_compared_modules():
    assert {k.split(":")[0] for k in DELIBERATE} <= set(MODULES)


def test_the_repaired_keywords_work():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers

    for opt in (fluid.optimizer.SGD(0.1, name="opt"),
                fluid.optimizer.Momentum(0.1, 0.9, name="opt"),
                fluid.optimizer.Adam(0.1, name="opt")):
        assert opt._name == "opt"
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        x = layers.data("x", [3], type="ignored")
    assert tuple(x.shape) == (-1, 3)


def test_compared_modules_cover_the_public_surface():
    for rel in ("", "optimizer", "layers.io", "core.executor", "amp",
                "guard", "fault", "telemetry", "serving.decode",
                "serving.kv_cache", "io", "tracing", "distributed.rpc",
                "serving", "serving.engine", "serving.batcher",
                "serving.server", "serving.compile_cache", "parallel",
                "parallel.mesh", "parallel.collectives",
                "parallel.distribute", "parallel.parallel_executor",
                "parallel.placement", "parallel.context_parallel"):
        assert rel in MODULES, rel
    assert os.path.basename(paddle_tpu_torch.__file__) == "__init__.py"


@pytest.mark.parametrize("rel,qual", [
    ("", "ParallelExecutor.__init__"), ("", "DistributeTranspiler"),
    ("parallel", "ParallelExecutor"), ("parallel", "CommConfig"),
    ("parallel", "make_mesh"), ("parallel", "DistributeTranspiler"),
    ("parallel.parallel_executor", "ParallelExecutor.run"),
    ("parallel.parallel_executor", "ParallelExecutor.set_mesh"),
    ("parallel.distribute", "DistributeTranspiler.transpile"),
    ("parallel.distribute", "init_multihost"),
    ("layers.control_flow", "ParallelDo"),
    ("layers.control_flow", "get_places"),
])
def test_the_parallel_names_are_compared(rel, qual):
    """The data-parallel names (ROADMAP.md Queue 1 item 4's core) are
    shared public names, compared like every other, with no deliberate
    difference: the port's added keywords all have defaults."""
    assert rel in MODULES
    jm, tm = _module("paddle_tpu", rel), _module("paddle_tpu_torch", rel)
    found = {q: (a, b) for q, a, b in _callables(jm, tm)}
    assert qual in found
    assert not _differences(*found[qual])
    assert not [k for k in DELIBERATE if k == "%s:%s" % (rel, qual)]


@pytest.mark.parametrize("rel,qual", [
    ("layers.nn", "multi_head_attention"), ("layers.nn", "flash_attention"),
    ("models.transformer", "transformer_lm"),
    ("models.transformer", "build_transformer_lm"),
    ("parallel.parallel_executor", "ParallelExecutor.__init__"),
    ("parallel.collectives", "mp_specs"),
    ("parallel.context_parallel", "ring_attention"),
    ("parallel.context_parallel", "context_parallel_attention"),
    ("parallel.placement", "Placement.mesh_for"),
    ("parallel.placement", "legal_placements"),
    ("parallel.placement", "plan_stages"),
    ("parallel.placement", "hbm_report"),
    ("parallel.placement", "estimate_wire_bytes"),
    ("parallel.placement", "rank"),
])
def test_the_tensor_and_sequence_axis_names_are_compared(rel, qual):
    """``mp=`` and ``seq_axis=`` are taken (and run) wherever the JAX
    package takes them, and the tensor and sequence axes' modules are
    compared like every other, with no deliberate difference."""
    assert rel in MODULES
    jm, tm = _module("paddle_tpu", rel), _module("paddle_tpu_torch", rel)
    found = {q: (a, b) for q, a, b in _callables(jm, tm)}
    assert qual in found
    assert not _differences(*found[qual])
    assert not [k for k in DELIBERATE if k == "%s:%s" % (rel, qual)]


_DISTRIBUTED = [
    ("distributed", n) for n in (
        "MasterServer", "MasterClient", "CheckpointManager",
        "save_checkpoint", "load_checkpoint", "latest_checkpoint",
        "RpcChannel", "CircuitBreaker", "Preemption", "RecoveryLoop",
        "train_with_recovery", "init_multihost")] + [
    ("distributed.checkpoint", "CheckpointManager.save"),
    ("distributed.checkpoint", "CheckpointManager.restore"),
    ("distributed.sharded_checkpoint", "snapshot_state"),
    ("distributed.sharded_checkpoint", "reshard_state"),
    ("distributed.sharded_checkpoint", "save_sharded_checkpoint"),
    ("distributed.sharded_checkpoint", "load_sharded_checkpoint"),
    ("distributed.sharded_checkpoint", "latest_sharded_checkpoint"),
    ("distributed.sharded_checkpoint", "quarantine_step"),
    ("distributed.sharded_checkpoint", "ShardedCheckpointManager"),
    ("distributed.sharded_checkpoint",
     "ShardedCheckpointManager.restore_last_healthy"),
    ("distributed.recovery", "ElasticRecoveryLoop"),
    ("distributed.recovery", "RecoveryLoop.run"),
    ("distributed.recovery", "Reshard"),
    ("distributed.recovery", "raise_on_sigterm"),
    ("distributed.membership", "MembershipServer"),
    ("distributed.membership", "MembershipClient"),
    ("distributed.membership", "MembershipClient.register"),
    ("distributed.membership", "MembershipClient.watch_world"),
    ("distributed.membership", "EpochWatcher"),
    ("distributed.membership", "EpochWatcher.shared"),
    ("distributed.membership", "shared_watchers"),
    ("distributed.master", "MasterServer.rpc_set_dataset"),
    ("distributed.master", "MasterClient.tasks"),
    ("distributed.pserver", "ParameterServer"),
    ("distributed.pserver", "PServerClient"),
    ("native", "RecordIOWriter"), ("native", "RecordLoader"),
    ("native", "TaskQueue"), ("native", "BufferPool"),
    ("recordio_writer", "convert_reader_to_recordio_files"),
    ("recordio_writer", "recordio_sample_reader"),
    ("dataset.common", "convert"),
    ("parallel.parallel_executor", "ParallelExecutor.set_mesh"),
    ("serving.server", "ServingServer.register"),
]


def test_the_distributed_exports_are_the_jax_packages():
    """``paddle_tpu_torch.distributed`` exports exactly what the JAX
    package's ``distributed`` exports."""
    import paddle_tpu.distributed as jd
    import paddle_tpu_torch.distributed as td

    def public(m):
        return {n for n in vars(m) if not n.startswith("_")
                and not isinstance(vars(m)[n], type(os))}

    assert public(td) == public(jd)


@pytest.mark.parametrize("rel,qual", _DISTRIBUTED)
def test_the_distributed_names_are_compared(rel, qual):
    """The checkpoint, recovery, membership, master and parameter-server
    names, the host runtime's and ``set_mesh`` take every keyword of the
    JAX package's, with no deliberate difference (the port's added
    keywords — ``place``, ``num_processes`` — all have defaults)."""
    assert rel in MODULES
    jm, tm = _module("paddle_tpu", rel), _module("paddle_tpu_torch", rel)
    found = {q: (a, b) for q, a, b in _callables(jm, tm)}
    assert qual in found
    assert not _differences(*found[qual])
    assert not [k for k in DELIBERATE if k == "%s:%s" % (rel, qual)]


@pytest.mark.parametrize("rel,qual", [
    ("layers.pipeline", "Pipeline"),
    ("layers.pipeline", "Pipeline.__init__"),
    ("layers.pipeline", "Pipeline.stage"),
    ("layers.pipeline", "Pipeline.input"),
    ("layers.pipeline", "Pipeline.output"),
    ("layers.nn", "moe"),
    ("parallel.pipeline", "pipeline_parallel_stacked"),
    ("parallel.pipeline", "pipeline_1f1b"),
    ("parallel.pipeline", "pipeline_parallel"),
    ("parallel.pipeline", "split_microbatches"),
    ("parallel.pipeline", "join_microbatches"),
    ("parallel.expert_parallel", "switch_moe"),
    ("parallel.expert_parallel", "topk_moe"),
    ("parallel.expert_parallel", "init_moe_params"),
    ("parallel.expert_parallel", "moe_param_shardings"),
    ("models.transformer", "transformer_lm"),
])
def test_the_pipeline_and_expert_axis_names_are_compared(rel, qual):
    """``layers.Pipeline``, ``layers.moe``, the pipeline schedules and the
    expert functions take every keyword of the JAX package's, with no
    deliberate difference (``pp_stages``/``pp_micro``/``pp_schedule`` of
    the transformer among them)."""
    assert rel in MODULES
    jm, tm = _module("paddle_tpu", rel), _module("paddle_tpu_torch", rel)
    found = {q: (a, b) for q, a, b in _callables(jm, tm)}
    assert qual in found
    assert not _differences(*found[qual])
    assert not [k for k in DELIBERATE if k == "%s:%s" % (rel, qual)]


@pytest.mark.parametrize("rel,qual", [
    ("layers.decoder", "BeamSearchDecoder"),
    ("layers.decoder", "BeamSearchDecoder.__init__"),
    ("layers.control_flow", "StaticRNN.memory"),
    ("optimizer", "Adagrad"),
    ("optimizer", "AdagradOptimizer"),
    ("layers.tensor", "fill_constant_batch_size_like"),
    ("models.seq2seq", "build_seq2seq"),
    ("models.seq2seq", "seq2seq_decode"),
    ("layers.nn", "sigmoid"),
    ("layers.nn", "prelu"),
    ("core.lower", "RowSparse"),
    ("core.lower", "RowSparse.astype"),
])
def test_the_beam_decode_and_sparse_names_are_compared(rel, qual):
    """The names the beam-search decode and the row-sparse gradients
    brought are shared public names, compared like every other, with
    no deliberate difference."""
    assert rel in MODULES
    jm, tm = _module("paddle_tpu", rel), _module("paddle_tpu_torch", rel)
    found = {q: (a, b) for q, a, b in _callables(jm, tm)}
    assert qual in found
    assert not _differences(*found[qual])
    assert not [k for k in DELIBERATE if k == "%s:%s" % (rel, qual)]


@pytest.mark.parametrize("rel,qual", [
    ("layers.nn", n) for n in (
        "conv3d", "conv2d_transpose", "pool3d", "max_pool3d_with_index",
        "conv3d_transpose", "unpool", "spp", "im2sequence", "grid_sampler",
        "image_resize", "resize_bilinear", "resize_nearest", "group_norm",
        "batch_norm_1d", "sequence_last_step", "dice_loss")] + [
    ("layers.detection", n) for n in (
        "prior_box", "box_coder", "iou_similarity", "bipartite_match",
        "detection_output", "ssd_loss", "target_assign", "multiclass_nms",
        "mine_hard_examples", "detection_map")] + [
    ("param_attr", "WeightNormParamAttr"),
    ("param_attr", "WeightNormParamAttr.__init__")])
def test_the_vision_and_detection_names_are_compared(rel, qual):
    """The names the vision and detection families brought are shared
    public names, compared like every other, with no deliberate
    difference."""
    assert rel in MODULES
    jm, tm = _module("paddle_tpu", rel), _module("paddle_tpu_torch", rel)
    found = {q: (a, b) for q, a, b in _callables(jm, tm)}
    assert qual in found
    assert not _differences(*found[qual])
    assert not [k for k in DELIBERATE if k == "%s:%s" % (rel, qual)]


@pytest.mark.parametrize("rel,qual", [
    ("layers.nn", n) for n in (
        "lod_reset", "sequence_softmax", "sequence_expand",
        "sequence_reshape", "sequence_reverse", "sequence_concat",
        "sequence_slice", "sequence_unpad", "warpctc", "ctc_greedy_decoder",
        "edit_distance")])
def test_the_sequence_and_ctc_names_are_compared(rel, qual):
    """The 11 layers the sequence and CTC families brought are shared
    public names (``sequence_softmax``'s ``use_cudnn``, ``warpctc``'s
    ``norm_by_times``, ``edit_distance``'s ``normalized`` ...), compared
    like every other, with no deliberate difference."""
    assert rel in MODULES
    jm, tm = _module("paddle_tpu", rel), _module("paddle_tpu_torch", rel)
    found = {q: (a, b) for q, a, b in _callables(jm, tm)}
    assert qual in found
    assert not _differences(*found[qual])
    assert not [k for k in DELIBERATE if k == "%s:%s" % (rel, qual)]


@pytest.mark.parametrize("rel,qual", [
    ("v2", "init"), ("v2", "infer"), ("v2", "batch"),
    ("v2.trainer", "SGD.__init__"), ("v2.trainer", "SGD.train"),
    ("v2.trainer", "SGD.test"), ("v2.parameters", "create"),
    ("v2.parameters", "Parameters.from_tar"),
    ("v2.parameters", "Parameters.init_from_tar"),
    ("v2.inference", "Inference.__init__"), ("v2.layer", "lstmemory"),
    ("v2.layer", "grumemory"), ("v2.layer", "beam_search"),
    ("v2.networks", "simple_gru"), ("v2.optimizer", "Adam.__init__"),
    ("v2.evaluator", "detection_map_evaluator"),
    ("reader", "device_chunks"), ("reader", "double_buffer"),
    ("reader.decorator", "super_batch"), ("reader.batch", "batch"),
    ("dataset.common", "download"), ("dataset.common", "convert"),
    ("dataset.imdb", "train"), ("dataset.movielens", "MovieInfo.__init__"),
    ("dataset.wmt16", "train")])
def test_the_v2_reader_and_dataset_names_are_compared(rel, qual):
    """The v2 frontend, the readers and the dataset loaders are shared
    public names, compared like every other; the one deliberate
    difference is ``v2.init``'s ``use_gpu`` default (the card)."""
    assert rel in MODULES
    jm, tm = _module("paddle_tpu", rel), _module("paddle_tpu_torch", rel)
    found = {q: (a, b) for q, a, b in _callables(jm, tm)}
    assert qual in found
    listed = DELIBERATE.get("%s:%s" % (rel, qual), {})
    assert set(_differences(*found[qual])) == set(listed)


def test_top_level_names_the_port_lacks_are_listed():
    """Every public top-level name of the JAX package is the port's too,
    or is listed in TOP_LEVEL_ABSENT with its reason; a listed name the
    port gained leaves the list. The names this slice brought are
    compared above (PUBLIC[""])."""
    import ast

    # the names the JAX package's __init__ binds (dir() would also list
    # the submodules other tests imported in this process)
    with open(paddle_tpu.__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update(a.asname or a.name.split(".")[0]
                         for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    missing = {n for n in names if not n.startswith("_")
               and not hasattr(paddle_tpu_torch, n)}
    assert missing == set(TOP_LEVEL_ABSENT), (
        sorted(missing - set(TOP_LEVEL_ABSENT)),
        sorted(set(TOP_LEVEL_ABSENT) - missing))
    for n in PUBLIC[""]:
        assert hasattr(paddle_tpu, n) and hasattr(paddle_tpu_torch, n), n
    assert paddle_tpu_torch.op_registry is importlib.import_module(
        "paddle_tpu_torch.core.registry")
    assert paddle_tpu_torch.is_compiled_with_tpu() is False
