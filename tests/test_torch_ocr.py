"""The CRNN-CTC text recognizer (``chip_smoke.crnn_build``, the one
function the card runs at full width) in the port against the JAX
package, on the CPU, at a reduced width: a 48 x 128 input (16 frames),
conv channels 4, 8, 8, 16, GRUs of 16 and of an odd 24, batch 4, labels
of 2..6 ids. For the published relu candidate (both packages run the
GRU's step loop) and for tanh (the GRU kernel's path: the JAX package's
jnp reference on the CPU, the port's plain versions of B5 and B6):

* the train, startup and eval programs' JSON byte-identical;
* from the JAX startup's weights (``interop.load_reference_state``), 3
  Momentum steps' losses within rtol 1e-5 and every parameter's
  gradient at each step within rtol 1e-5 plus 1e-6 of its largest
  magnitude (``tests/torch_dense_harness.py``'s bound) plus 1e-9 of the
  step's largest gradient entry. That last term is for the conv trunk:
  at the published initialisers (eight batch norms whose scales are
  drawn from N(0, 0.01)) its gradients are 1e-15 to 1e-8 of the largest
  (the fcs' and GRUs'), sums over 24576 positions a channel that
  cancel. A conv bias under a batch norm has a gradient of 0 in exact
  arithmetic: rounding noise in both packages (up to 7e-8 of the
  largest entry), held under 1e-6 of it in both and not compared;
* the eval program on the trained weights: the greedy decodes (ids and
  lengths) and the edit distances exact.

Every row has all its frames (equal lengths), so the JAX reverse GRU's
fault at position 0 of short rows (ROADMAP.md Queue 3) does not arise."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import interop

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
SMALL = dict(width=128, channels=(4, 8, 8, 16))
SMALL_B, SMALL_LABELS = 4, (2, 6)
VARIANTS = [("relu", 16), ("tanh", 16), ("relu", 24), ("tanh", 24)]


def _build(fluid, act, hidden):
    with fluid.unique_name.guard():
        return chip_smoke.crnn_build(fluid, act=act, hidden=hidden, **SMALL)


def _dump(prog):
    return json.dumps(prog.to_dict(), sort_keys=True)


@pytest.mark.parametrize("act,hidden", VARIANTS[:2])
def test_crnn_programs_json_is_the_jax_packages(act, hidden):
    j, t = _build(jfluid, act, hidden), _build(tfluid, act, hidden)
    for i in range(3):
        assert _dump(t[i]) == _dump(j[i]), i
    types = [op.type for op in t[0].global_block().ops]
    for want in ("im2sequence", "sequence_unpad", "gru", "warpctc",
                 "warpctc_grad", "sequence_unpad_grad", "momentum"):
        assert want in types, want
    assert [op.type for op in t[2].global_block().ops][-3:] == \
        ["ctc_align", "cast", "edit_distance"]
    assert all(op.attrs["activation"] == act for op in
               t[0].global_block().ops if op.type == "gru")
    # the full width: 64 frames of 768, 96 classes
    with tfluid.unique_name.guard():
        full = chip_smoke.crnn_build(tfluid, act=act)
    assert tuple(full[3][1].shape) == (-1, 64, 96)
    unpad = next(op for op in full[0].global_block().ops
                 if op.type == "sequence_unpad")
    assert tuple(full[0].global_block().var(unpad.input("X")[0]).shape) \
        == (-1, 64, 768)


def _carried(act, hidden):
    j, t = _build(jfluid, act, hidden), _build(tfluid, act, hidden)
    jscope, jexe = jfluid.Scope(), jfluid.Executor()
    jexe.run(j[1], scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in j[0].list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [t[0], t[1]])
    feed = chip_smoke.crnn_feed(np.random.RandomState(hidden), SMALL_B,
                                SMALL["width"], lengths=SMALL_LABELS)
    return j, t, jscope, jexe, tscope, feed


@pytest.mark.parametrize("act,hidden", VARIANTS)
def test_crnn_momentum_steps_and_eval(act, hidden):
    j, t, jscope, jexe, tscope, feed = _carried(act, hidden)
    texe = tfluid.Executor(CPU)
    grads = sorted(p.name + "@GRAD"
                   for p in t[0].global_block().all_parameters())
    # 8 convs and 8 batch norms (two each), two fcs and two GRUs (two
    # each), the output fc's two weights and bias
    assert len(grads) == 8 * 2 + 8 * 2 + 2 * 2 + 2 * 2 + 3
    losses = []
    for step in range(3):
        jo = jexe.run(j[0], feed=feed, fetch_list=[j[3][0].name] + grads,
                      scope=jscope)
        to = texe.run(t[0], feed=feed, fetch_list=[t[3][0].name] + grads,
                      scope=tscope)
        np.testing.assert_allclose(to[0], np.asarray(jo[0]), rtol=1e-5,
                                   err_msg="loss at step %d" % step)
        top = max(float(np.abs(np.asarray(b)).max()) for b in jo[1:])
        for name, a, b in zip(grads, to[1:], jo[1:]):
            b = np.asarray(b)
            if name.startswith("conv2d_") and ".b_" in name:
                assert max(np.abs(a).max(), np.abs(b).max()) < 1e-6 * top
                continue
            np.testing.assert_allclose(
                a, b, rtol=1e-5, atol=1e-6 * float(np.abs(b).max())
                + 1e-9 * top, err_msg="%s at step %d" % (name, step))
        losses.append(float(to[0]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses

    jd, jdist = jexe.run(j[2], feed=feed, fetch_list=[j[4][0].name,
                                                      j[4][1].name],
                         scope=jscope)
    td, tdist = texe.run(t[2], feed=feed, fetch_list=list(t[4]),
                         scope=tscope, return_numpy=False)
    np.testing.assert_array_equal(td.lengths.numpy(), np.asarray(jd.lengths))
    np.testing.assert_array_equal(td.data.numpy(), np.asarray(jd.data))
    assert td.data.dtype == torch.int32
    np.testing.assert_array_equal(tdist.numpy(), np.asarray(jdist))
    frames = SMALL["width"] // 8
    assert (td.data.numpy() >= 0).all() and (td.data.numpy() < 95).all()
    assert (td.lengths.numpy() <= frames).all()
    assert (tdist.numpy() >= 0).all()


def test_crnn_labels_are_alignable():
    rows = chip_smoke.crnn_labels(np.random.RandomState(0), 200, 64)
    for r in rows:
        r = r[:, 0]
        assert 8 <= len(r) <= 24 and (r >= 0).all() and (r < 95).all()
        assert len(r) + int((r[1:] == r[:-1]).sum()) <= 64
