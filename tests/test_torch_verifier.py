"""The port's IR verifier (``paddle_tpu_torch.analysis``) against the JAX
package's, on the CPU.

Each case builds the same program in both packages (same ``unique_name``
counters, so the same names and uids) and holds the port to the JAX
package: the stock programs verify clean and infer the same shapes and
dtypes; each deliberately broken program raises a ``VerifyError`` with
the same check slug, op, uid, block, var and message; each pipeline
pass's post-condition hook names its pass; ``FLAGS_verify_ir`` never
enters a plan key; and the stock programs verify clean after every pass
under every PassConfig of the JAX package's ladder that rewrites
something (``tools/ir_lint.py``'s matrix). The one rule the port amends
(a program's first ``write_to_array``) is held last.
"""

import importlib
import os
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
PKGS = ("jax", "torch")


def ns(pkg):
    """The modules of one package under short names."""
    root = "paddle_tpu" if pkg == "jax" else "paddle_tpu_torch"
    m = types.SimpleNamespace(fluid=jfluid if pkg == "jax" else tfluid)
    for name in ("layers", "passes", "analysis", "unique_name",
                 "telemetry", "analysis.effects", "models.lenet",
                 "models.resnet", "models.vgg", "models.seq2seq",
                 "models.transformer"):
        setattr(m, name.split(".")[-1],
                importlib.import_module("%s.%s" % (root, name)))
    return m


def _mnist(m, model="cnn", layout=None):
    with m.unique_name.guard():
        return m.lenet.build_mnist_train(model, layout=layout or "NCHW")


def _conv_residual_net(m):
    """conv -> bn -> (+residual) -> relu with a backward: every pipeline
    pass has something to do (tests/test_verifier.py's program)."""
    fluid, layers = m.fluid, m.layers
    with m.unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            img = layers.data("img", [8, 8, 8])
            short = layers.conv2d(img, 8, 1, act=None, bias_attr=False)
            y = layers.conv2d(img, 8, 3, padding=1, act=None,
                              bias_attr=False)
            y = layers.batch_norm(y)
            y = layers.elementwise_add(y, short)
            y = layers.relu(y)
            z = layers.conv2d(y, 8, 3, padding=1, act=None,
                              bias_attr=False)
            z = layers.batch_norm(z)
            z = layers.relu(z)
            loss = layers.mean(z)
            fluid.optimizer.SGD(0.1).minimize(loss)
    return prog, startup, loss


def _attribution(e):
    return (e.check, e.op_type, e.op_uid, e.block_idx, e.var, e.pass_name,
            str(e))


def _shapes(env):
    """An inferred env with symbols named by their position only (the
    two packages name a symbol the same way, but compare its identity
    by object)."""
    return {n: (None if i.shape is None else tuple(
        d if isinstance(d, int) else "?" for d in i.shape), i.dtype)
        for n, i in env.items()}


# ---------------------------------------------------------------------------
# golden-clean
# ---------------------------------------------------------------------------


def _lenet_env(m):
    prog, startup, _feeds, fetches = _mnist(m)
    m.analysis.verify(startup)
    return m.analysis.verify(prog, fetch_names=[f.name for f in fetches])


def _decode_pair_env(m):
    with m.unique_name.guard():
        prefill, decode, _meta = m.transformer.build_transformer_decode(
            64, d_model=32, num_layers=2, num_heads=4, max_len=32)
    return dict(m.analysis.verify(prefill),
                **{"decode/" + k: v
                   for k, v in m.analysis.verify(decode).items()})


def _mlp_method_env(m):
    prog, _startup, _f, fetches = _mnist(m, "mlp")
    return prog.verify(fetch_names=[f.name for f in fetches])


@pytest.mark.parametrize("build", [_lenet_env, _decode_pair_env,
                                   _mlp_method_env],
                         ids=["lenet", "transformer_decode", "mlp_method"])
def test_stock_programs_verify_clean_with_the_jax_packages_shapes(build):
    """``analysis.verify`` / ``Program.verify`` pass on the stock
    programs in both packages, and ``infer_program`` gives the same
    shape and dtype to every name, backward included."""
    envs = [build(ns(p)) for p in PKGS]
    assert _shapes(envs[1]) == _shapes(envs[0])
    grads = [n for n in envs[1] if n.endswith("@GRAD")]
    assert build is _decode_pair_env or (
        grads and any(envs[1][g].shape is not None for g in grads))


def test_infer_program_matches_on_the_transformer_and_resnet():
    """The shape rules over bigger programs (attention, layer norm,
    conv + batch norm, pools), each with its backward."""
    for build in (
            lambda m: m.transformer.build_transformer_lm(
                vocab_size=64, seq_len=16, d_model=32, num_layers=2,
                num_heads=4),
            lambda m: m.resnet.build_resnet50_train(
                image_shape=(3, 32, 32), class_dim=10, depth=18)):
        envs = []
        for p in PKGS:
            m = ns(p)
            with m.unique_name.guard():
                prog = build(m)[0]
            envs.append(m.analysis.infer_program(prog))
        assert _shapes(envs[1]) == _shapes(envs[0])


# ---------------------------------------------------------------------------
# one broken program per check class: same slug, attribution and message
# ---------------------------------------------------------------------------


def _undeclared(m):
    prog, _s, _f, _fe = _mnist(m, "mlp")
    prog.global_block().append_op(
        "relu", {"X": ["never_declared"]}, {"Out": ["d_out"]})
    prog.global_block().create_var(name="d_out")
    prog.verify()


def _use_before_def(m):
    prog, _s, _f, _fe = _mnist(m, "mlp")
    b = prog.global_block()
    b.create_var(name="ghost", shape=[4], dtype="float32")
    b.create_var(name="g_out")
    b.prepend_op("relu", {"X": ["ghost"]}, {"Out": ["g_out"]})
    prog.verify()


def _conv(m):
    prog, _s, _f, _fe = _mnist(m, "cnn")
    return prog, next(op for op in prog.global_block().ops
                      if op.type == "conv2d")


def _attr_type(m):
    prog, conv = _conv(m)
    conv.attrs["strides"] = "wide"
    prog.verify()


def _attr_enum(m):
    prog, conv = _conv(m)
    conv.attrs["data_layout"] = "HWCN"
    prog.verify()


def _fused_epilogue_shape(m):
    prog, _startup, loss = _conv_residual_net(m)
    probe = prog.clone()
    probe.passes = m.passes.PassConfig(epilogue_fusion=True)
    out, report = m.passes.apply(probe, protected={loss.name})
    assert report.get("epilogue", 0) >= 1
    fused = next(op for op in out.global_block().ops
                 if op.type == "conv2d_bn_act")
    bad = out.global_block().create_var(
        name="bad_scale", shape=[3], dtype="float32", persistable=True)
    fused.inputs["Scale"] = [bad.name]
    out.verify(fetch_names=[loss.name])


def _dtype_accumulation(m):
    fluid, layers = m.fluid, m.layers
    with m.unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            a = layers.data("fa", [4])
            b = layers.data("ib", [4], dtype="int64")
            out = prog.current_block().create_var(
                name="mixed_sum", shape=[-1, 4], dtype="float32")
            prog.current_block().append_op(
                "sum", {"X": [a.name, b.name]}, {"Out": [out.name]})
    prog.verify()


def _grad_link(m):
    prog, _s, _f, _fe = _mnist(m, "mlp")
    gop = next(op for op in prog.global_block().ops
               if op.type.endswith("_grad"))
    gop.attrs["fwd_op_uid"] = 999999
    prog.verify()


def _fetch_reachability(m):
    prog, _s, _f, _fe = _mnist(m, "mlp")
    prog.verify(fetch_names=["not_a_var_anywhere"])


def _remat_freed_var(m):
    prog, _startup, loss = _conv_residual_net(m)
    probe = prog.clone()
    probe.passes = m.passes.PassConfig(remat="blocks")
    out, report = m.passes.apply(probe, protected={loss.name})
    assert report.get("remat", 0) >= 1
    seg = out._remat_plan.segments[0]
    later = out.global_block().ops[seg.end]
    foreign = next(n for ns_ in later.outputs.values() for n in ns_ if n)
    seg.internal = seg.internal + (foreign,)
    out.verify(fetch_names=[loss.name])


def _bucket_plan_missing_a_grad(m):
    prog, _s, _f, _fe = _mnist(m, "mlp")
    pg = list(prog._op_role_vars)
    assert len(pg) >= 2

    class FakeBucket:
        idx = 0

        def __init__(self, grads):
            self.grads = grads

    class FakeCfg:
        zero_stage = 0

    class FakePlan:
        config = FakeCfg()
        buckets = [FakeBucket([(p, g) for p, g in pg[:-1]])]

    m.effects.check_comm_plan(FakePlan(), prog)


def _feed_overwrite(m):
    fluid, layers = m.fluid, m.layers
    with m.unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            x = layers.data("ax", [4])
            y = layers.relu(x)
            prog.current_block().append_op(
                "assign", {"X": [y.name]}, {"Out": [x.name]})
    m.analysis.verify(prog, feed_infos={
        "ax": m.analysis.feed_info(np.zeros((2, 4), np.float32))})


def _concat_axis(m):
    fluid, layers = m.fluid, m.layers
    with m.unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            a = layers.data("ca", [4])
            b = layers.data("cb", [4])
            layers.concat([a, b], axis=1)
    cop = next(op for op in prog.global_block().ops if op.type == "concat")
    cop.attrs["axis"] = 5
    prog.verify()


def _sub_block_range(m):
    prog, _s, _f, _fe = _mnist(m, "mlp")
    prog.global_block().ops[0].attrs["sub_block_id"] = 42
    prog.verify()


def _feed_signature(m):
    prog, _startup, _feeds, fetches = _mnist(m, "cnn", layout="NHWC")
    m.analysis.verify(
        prog, fetch_names=[f.name for f in fetches],
        feed_infos={"img": m.analysis.feed_info(
            np.zeros((2, 1, 28, 28), np.float32))})


def _uid_unique(m):
    prog, _s, _f, _fe = _mnist(m, "mlp")
    ops = prog.global_block().ops
    ops[3].uid = ops[1].uid
    prog.verify()


def _persistable_decl(m):
    prog, _s, _f, _fe = _mnist(m, "mlp")
    sub = prog.create_block()
    sub.create_var(name="stray_state", shape=[2], dtype="float32",
                   persistable=True)
    prog.rollback()
    prog.verify()


BROKEN = {
    "undeclared-var": (_undeclared, "never_declared"),
    "def-before-use": (_use_before_def, "ghost"),
    "attr-schema-type": (_attr_type, None),
    "attr-schema-enum": (_attr_enum, None),
    "shape-conflict-fused": (_fused_epilogue_shape, None),
    "dtype-conflict": (_dtype_accumulation, None),
    "grad-link": (_grad_link, None),
    "fetch-reachability": (_fetch_reachability, "not_a_var_anywhere"),
    "remat-plan": (_remat_freed_var, None),
    "comm-plan": (_bucket_plan_missing_a_grad, None),
    "feed-overwrite": (_feed_overwrite, "ax"),
    "shape-conflict-concat": (_concat_axis, None),
    "sub-block": (_sub_block_range, None),
    "feed-signature": (_feed_signature, "img"),
    "uid-unique": (_uid_unique, None),
    "persistable-decl": (_persistable_decl, "stray_state"),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_broken_program_raises_the_jax_packages_error(case):
    """One deliberately broken program per check class: the port's
    ``VerifyError`` has the JAX one's slug, op type and uid, block, var
    and message, word for word."""
    build, var = BROKEN[case]
    errs = []
    for p in PKGS:
        m = ns(p)
        with pytest.raises(m.analysis.VerifyError) as ei:
            build(m)
        errs.append(ei.value)
    assert _attribution(errs[1]) == _attribution(errs[0])
    assert errs[1].check == case.split("-fused")[0].split("-concat")[0] \
        .replace("attr-schema-type", "attr-schema") \
        .replace("attr-schema-enum", "attr-schema")
    if var is not None:
        assert errs[1].var == var


def test_rank0_with_dim_attrs_stays_declared_trust():
    """A reduce/squeeze over a rank-0 value with a dim attr verifies in
    both packages (no untyped crash)."""
    for p in PKGS:
        m = ns(p)
        fluid, layers = m.fluid, m.layers
        with m.unique_name.guard():
            prog, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(prog, startup):
                x = layers.data("r0x", [4])
                mval = layers.mean(x)
                b = prog.current_block()
                for op_type, attrs in (("reduce_sum", {"dim": 0}),
                                       ("squeeze", {"axes": [0]})):
                    out = b.create_var(name="%s_r0" % op_type)
                    b.append_op(op_type, {"X": [mval.name]},
                                {"Out": [out.name]}, attrs)
        prog.verify()


# ---------------------------------------------------------------------------
# mutation tests: each pipeline pass's post-condition hook fires
# ---------------------------------------------------------------------------


def _sabotage(program):
    """The canonical bad rewrite: re-bind the last op's first input to
    a name no block declares."""
    for op in reversed(program.global_block().ops):
        for _slot, names in op.inputs.items():
            if names and names[0]:
                names[0] = "mutant@undeclared"
                return


_FULL_CFG = dict(layout="NHWC", feed_layout="NCHW", epilogue_fusion=True,
                 pallas_reductions=True,
                 kernel_params=(("batch_norm_grad", "tile", 256),),
                 remat="blocks")


@pytest.mark.parametrize("pass_name", ["layout", "epilogue", "reductions",
                                       "kernels", "remat"])
def test_bad_rewrite_is_caught_by_the_stage_hook(monkeypatch, pass_name):
    """Each pass made to corrupt its output: the stage's verify raises
    a VerifyError attributed to THAT pass, as the JAX package's does
    (same attribution and message)."""
    errs = []
    for p in PKGS:
        m = ns(p)
        mod = importlib.import_module("%s.passes.%s" % (
            "paddle_tpu" if p == "jax" else "paddle_tpu_torch", pass_name))
        orig = mod.run

        def bad_run(program, cfg, protected=(), orig=orig):
            n = orig(program, cfg, protected)
            if pass_name == "remat":
                seg = program._remat_plan.segments[0]
                seg.internal = seg.internal + ("mutant@freed",)
                program.global_block().create_var(
                    name="mutant@freed", shape=[1], dtype="float32")
            else:
                _sabotage(program)
            return n

        monkeypatch.setattr(mod, "run", bad_run)
        prog, _startup, loss = _conv_residual_net(m)
        probe = prog.clone()
        probe.passes = m.passes.PassConfig(**_FULL_CFG)
        with pytest.raises(m.analysis.VerifyError) as ei:
            m.passes.apply(probe, protected={loss.name})
        errs.append(ei.value)
    assert errs[1].pass_name == pass_name
    assert errs[1].check in ("undeclared-var", "remat-plan")
    assert _attribution(errs[1]) == _attribution(errs[0])


def test_executor_plan_raises_the_typed_error(monkeypatch):
    """End to end: a bad layout rewrite surfaces from ``Executor.run``
    as the typed VerifyError naming its pass, before any op runs."""
    m = ns("torch")
    orig = m.passes._layout.run

    def bad_run(program, cfg, protected=()):
        n = orig(program, cfg, protected)
        _sabotage(program)
        return n

    monkeypatch.setattr(m.passes._layout, "run", bad_run)
    prog, startup, loss = _conv_residual_net(m)
    m.passes.enable(prog, layout="NHWC", feed_layout="NCHW")
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    with pytest.raises(m.analysis.VerifyError) as ei:
        exe.run(prog, feed={"img": np.zeros((2, 8, 8, 8), np.float32)},
                fetch_list=[loss.name], scope=scope)
    assert ei.value.pass_name == "layout"


def test_feed_signature_is_checked_once_per_new_signature():
    """A plan verifies the first call of each (feed signature, fetches,
    scope) and none after: a channels mix-up fed to a plan that already
    ran is still caught, and a repeated call costs no verification."""
    m = ns("torch")
    prog, startup, _feeds, fetches = _mnist(m, "mlp")
    scope = tfluid.Scope()
    exe = tfluid.Executor(CPU)
    exe.run(startup, scope=scope)
    feed = {"img": np.zeros((2, 784), np.float32),
            "label": np.zeros((2, 1), np.int64)}
    names = [f.name for f in fetches]
    exe.run(prog, feed=feed, fetch_list=names, scope=scope)
    runs = m.analysis.stats()["runs"]
    exe.run(prog, feed=feed, fetch_list=names, scope=scope)
    assert m.analysis.stats()["runs"] == runs
    bad = dict(feed, img=np.zeros((2, 783), np.float32))
    with pytest.raises(m.analysis.VerifyError) as ei:
        exe.run(prog, feed=bad, fetch_list=names, scope=scope)
    assert ei.value.check == "feed-signature" and ei.value.var == "img"
    assert m.analysis.stats()["runs"] == runs + 1


# ---------------------------------------------------------------------------
# the flag is invisible to plans
# ---------------------------------------------------------------------------


def test_verify_flag_never_enters_plan_key_or_miss_signature():
    """Flipping FLAGS_verify_ir builds no plan (and so captures no
    graph: graphs hang off the plan), and no miss signature names it."""
    m = ns("torch")
    m.telemetry.enable()
    try:
        prog, startup, _feeds, fetches = _mnist(m, "mlp")
        feed = {"img": np.zeros((2, 784), np.float32),
                "label": np.zeros((2, 1), np.int64)}
        names = [fetches[0].name]
        scope = tfluid.Scope()
        exe = tfluid.Executor(CPU)
        exe.run(startup, scope=scope)
        assert tfluid.get_flags("FLAGS_verify_ir")["FLAGS_verify_ir"] is True
        exe.run(prog, feed=feed, fetch_list=names, scope=scope)
        assert exe._last_plan_hit is False
        plans = dict(exe._plans)
        tfluid.set_flags({"FLAGS_verify_ir": False})
        try:
            exe.run(prog, feed=feed, fetch_list=names, scope=scope)
            assert exe._last_plan_hit is True
        finally:
            tfluid.set_flags({"FLAGS_verify_ir": True})
        exe.run(prog, feed=feed, fetch_list=names, scope=scope)
        assert exe._last_plan_hit is True
        assert exe._plans == plans
        for e in m.telemetry.recompile_detector.events:
            for d in e.get("diff", ()):
                assert not d.startswith("verify")
    finally:
        m.telemetry.disable()


def test_verify_off_skips_the_pipeline_hook():
    m = ns("torch")
    prog, _s, _f, _fe = _mnist(m, "mlp")
    prog.global_block().append_op(
        "relu", {"X": ["never_declared"]}, {"Out": ["nd_out"]})
    prog.global_block().create_var(name="nd_out")
    tfluid.set_flags({"FLAGS_verify_ir": False})
    try:
        assert not m.analysis.enabled()
        probe = prog.clone()
        probe.passes = m.passes.PassConfig(remat="blocks")
        m.passes.apply(probe)
    finally:
        tfluid.set_flags({"FLAGS_verify_ir": True})
    with pytest.raises(m.analysis.VerifyError):
        prog.verify()


def test_runs_and_failures_counted():
    """Telemetry counts each verification and each failure, under the
    JAX package's metric names; ``analysis.stats`` counts them with the
    telemetry off too."""
    m = ns("torch")
    m.telemetry.enable()
    try:
        prog, _s, _f, _fe = _mnist(m, "mlp")
        before = m.analysis.stats()
        m.analysis.verify(prog)
        roll = m.telemetry.summary()
        assert roll["paddle_tpu_analysis_verify_runs_total"] >= 1
        prog.global_block().append_op(
            "relu", {"X": ["never_declared"]}, {"Out": ["t_out"]})
        prog.global_block().create_var(name="t_out")
        with pytest.raises(m.analysis.VerifyError):
            m.analysis.verify(prog)
        roll = m.telemetry.summary()
        assert roll["paddle_tpu_analysis_verify_failures_total"] >= 1
        after = m.analysis.stats()
        assert after["runs"] == before["runs"] + 2
        assert after["failures"] == before["failures"] + 1
        assert after["seconds"] > before["seconds"]
    finally:
        m.telemetry.disable()


# ---------------------------------------------------------------------------
# tools/ir_lint.py's matrix: stock programs x the PassConfig ladder
# ---------------------------------------------------------------------------


def _stock(m, tag):
    """(main, startup, fetch names) of one stock program at a small
    width, as tools/ir_lint.py builds them."""
    with m.unique_name.guard():
        if tag == "lenet":
            built = m.lenet.build_mnist_train("cnn")
        elif tag == "resnet18":
            built = m.resnet.build_resnet50_train(
                image_shape=(3, 32, 32), class_dim=10, depth=18)
        elif tag == "vgg16":
            built = m.vgg.build_vgg16_train(image_shape=(3, 32, 32),
                                            class_dim=10)
        elif tag == "seq2seq":
            built = m.seq2seq.build_seq2seq(30, 30)
        elif tag == "seq2seq-decode":
            built = m.seq2seq.build_seq2seq(30, 30, mode="decode")
        elif tag == "transformer":
            built = m.transformer.build_transformer_lm(
                vocab_size=64, seq_len=16, d_model=32, num_layers=2,
                num_heads=4)
        else:
            prefill, decode, _meta = \
                m.transformer.build_transformer_decode(
                    64, d_model=32, num_layers=2, num_heads=4, max_len=32)
            return (prefill if tag == "transformer-prefill" else decode,
                    None, ())
    prog, startup, _feeds, fetches = built
    return prog, startup, tuple(getattr(f, "name", str(f))
                                for f in fetches)


# the JAX autotuner's pass ladder (paddle_tpu/autotune/space.py:238-247)
# with its last entry, which the port's reductions pass runs natively
# (the CUDA batch-norm backward), then the remat policies ir_lint adds
LADDER = (
    {"epilogue_fusion": True},
    {"layout": "NHWC", "feed_layout": "NCHW"},
    {"layout": "NHWC", "feed_layout": "NCHW", "epilogue_fusion": True},
    {"layout": "NHWC", "feed_layout": "NCHW", "epilogue_fusion": True,
     "pallas_reductions": True},
)
REMAT = ({"remat": "blocks"}, {"remat": "sqrt"},
         {"epilogue_fusion": True, "remat": "blocks"})
ATTENTION = ({"kernel_params": (("fused_attention", "block_k", 8),)},
             {"kernel_params": (("fused_attention", "block_k", 16),)})
CONV = ("lenet", "resnet18", "vgg16")
MATRIX = [(t, None) for t in CONV + ("seq2seq", "seq2seq-decode",
                                     "transformer", "transformer-prefill",
                                     "transformer-decode")] \
    + [(t, kw) for t in CONV for kw in LADDER + REMAT
       # the epilogue pass alone rewrites nothing in LeNet (no batch
       # norm) or VGG-16 (a conv bias sits before each batch norm)
       if kw is not LADDER[0] or t == "resnet18"] \
    + [("seq2seq", kw) for kw in REMAT[:2]] \
    + [("transformer", kw) for kw in ATTENTION + REMAT[:2]]


@pytest.mark.parametrize(
    "tag,kw", MATRIX,
    ids=["%s-%s" % (t, "base" if kw is None else "-".join(
        "%s=%s" % (k, v if k != "kernel_params" else v[0][2])
        for k, v in sorted(kw.items()))) for t, kw in MATRIX])
def test_ir_lint_matrix_verifies_clean_after_every_pass(tag, kw):
    """Every stock program under every rewriting PassConfig verifies
    clean after each port pass (``passes.apply``'s stage hook) and at
    the end; the startup programs verify too."""
    m = ns("torch")
    prog, startup, fetch_names = _stock(m, tag)
    if startup is not None and kw is None:
        m.analysis.verify(startup)
    if kw is None:
        m.analysis.verify(prog, fetch_names=fetch_names)
        return
    probe = prog.clone()
    probe.passes = m.passes.PassConfig(**kw)
    out, report = m.passes.apply(probe, protected=set(fetch_names))
    assert report and any(report.values()), report
    m.analysis.verify(out, fetch_names=fetch_names)


# ---------------------------------------------------------------------------
# the one amended rule
# ---------------------------------------------------------------------------


def test_first_array_write_refused_by_jax_verifier_run_by_the_port():
    """A program's first ``write_to_array`` reads its array before
    anything defines it. The JAX verifier refuses it (def-before-use,
    ROADMAP Queue 3); the port's copy accepts that one read, and the
    port runs the program."""
    progs = []
    for p in PKGS:
        m = ns(p)
        fluid, layers = m.fluid, m.layers
        with m.unique_name.guard():
            prog, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(prog, startup):
                x = layers.data("x", [3])
                i = layers.fill_constant([1], "int64", 0)
                arr = layers.array_write(x, i)
                r = layers.array_read(arr, i)
        progs.append((prog, arr, r))
    jm = ns("jax")
    with pytest.raises(jm.analysis.VerifyError) as ei:
        progs[0][0].verify()
    assert ei.value.check == "def-before-use"
    assert ei.value.op_type == "write_to_array"
    prog, arr, r = progs[1]
    prog.verify(fetch_names=[r.name])
    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = tfluid.Executor(CPU).run(prog, feed={"x": xv}, fetch_list=[r],
                                   scope=tfluid.Scope())[0]
    assert np.array_equal(out, xv)
    # any other read before a definition stays refused
    b = prog.global_block()
    op = next(o for o in b.ops if o.type == "read_from_array")
    b.ops.remove(op)
    b.ops.insert(0, op)
    with pytest.raises(ns("torch").analysis.VerifyError) as ei:
        prog.verify()
    assert ei.value.check == "def-before-use"


def test_write_into_a_fed_array_refused_by_jax_verifier_run_by_the_port():
    """``write_to_array`` into a FED tensor array (Out is its Array
    input) updates the array the step fetches. The JAX verifier refuses
    it as feed-overwrite (ROADMAP Queue 3); the port's copy accepts that
    write, and the port's run fetches the written array. An ``assign``
    into the same fed array stays refused."""
    progs = []
    for p in PKGS:
        m = ns(p)
        fluid, layers = m.fluid, m.layers
        with m.unique_name.guard():
            prog, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(prog, startup):
                arr = prog.global_block().create_var(
                    name="arr", shape=None, dtype="float32",
                    type="tensor_array", is_data=True)
                i = layers.fill_constant([1], "int64", 1)
                layers.array_write(layers.array_read(arr, i) * 3.0, i,
                                   array=arr)
        progs.append(prog)
    jm, tm = ns("jax"), ns("torch")
    with pytest.raises(jm.analysis.VerifyError) as ei:
        jm.analysis.verify(progs[0], feed_infos={"arr": None})
    assert (ei.value.check, ei.value.op_type, ei.value.var) == (
        "feed-overwrite", "write_to_array", "arr")
    tm.analysis.verify(progs[1], fetch_names=["arr"],
                       feed_infos={"arr": None})
    data = np.arange(8, dtype=np.float32).reshape(4, 2)
    out = tfluid.Executor(CPU).run(
        progs[1], feed={"arr": tfluid.TensorArray(data, np.int32(3))},
        fetch_list=["arr"], scope=tfluid.Scope())[0]
    want = data.copy()
    want[1] *= 3.0
    assert np.array_equal(out.data, want)
    b = progs[1].global_block()
    b.append_op("assign", {"X": ["arr"]}, {"Out": ["arr"]})
    with pytest.raises(tm.analysis.VerifyError) as ei:
        tm.analysis.verify(progs[1], feed_infos={"arr": None})
    assert ei.value.check == "feed-overwrite"
