"""The optimizer family's update ops in the port against the JAX package,
on the CPU, from the same numpy inputs (``tests/torch_dense_harness.py``):
each of the 9 types over 3 steps, each package carrying its own state
from step to step, every output at every step within rtol 1e-5 plus 1e-6
of the largest magnitude (integers exact), with the JAX package's flags
(no_grad, the same stateful outputs).

The edge cases: RMSProp not centered returns no ``MeanGradOut`` in
either package (the mean gradient keeps its value), centered with
momentum; LAMB on a parameter whose norm is 0 (trust ratio 1); FTRL
from zero accumulators (its first step takes 0 ** -lr_power) with l1 and
l2 > 0; and a row-sparse gradient into each of the 8 updates raises in
both packages (neither has a sparse branch, and the port never makes
it dense quietly)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lower import RowSparse as JSparse
from paddle_tpu.core.lower import TraceContext as JCtx
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lower import RowSparse as TSparse
from paddle_tpu_torch.core.lower import TraceContext as TCtx
from torch_dense_harness import Op, run_jax, run_port, same

R = np.random.RandomState(17)
TYPES = ["adamax", "decayed_adagrad", "adadelta", "rmsprop", "ftrl",
         "proximal_gd", "proximal_adagrad", "lamb", "average_accumulates"]
LR = np.array([0.1], np.float32)


def _p(*shape):
    return R.randn(*shape).astype(np.float32)


def _pos(*shape):
    return (R.rand(*shape) * 0.1 + 0.01).astype(np.float32)


def _in_slot(type, out):
    """The input slot an output slot writes back."""
    if type == "average_accumulates":
        return "in_" + out[len("out_"):]
    return {"SquaredAccumOut": "SquaredAccumulator",
            "LinearAccumOut": "LinearAccumulator"}.get(out, out[:-3])


P43 = _p(4, 3)

CASES = [
    ("adamax", "adamax",
     {"Param": P43, "Moment": _pos(4, 3), "InfNorm": _pos(4, 3),
      "Beta1Pow": np.array([0.9], np.float32), "LearningRate": LR},
     {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("decayed_adagrad", "decayed_adagrad",
     {"Param": P43, "Moment": _pos(4, 3), "LearningRate": LR},
     {"decay": 0.95, "epsilon": 1e-6}),
    ("adadelta", "adadelta",
     {"Param": P43, "AvgSquaredGrad": _pos(4, 3),
      "AvgSquaredUpdate": _pos(4, 3)}, {"rho": 0.95, "epsilon": 1e-6}),
    ("rmsprop", "rmsprop",
     {"Param": P43, "Moment": _pos(4, 3), "MeanSquare": _pos(4, 3) + 0.1,
      "MeanGrad": _p(4, 3), "LearningRate": LR},
     {"decay": 0.95, "epsilon": 1e-6, "momentum": 0.0}),
    ("rmsprop_centered_momentum", "rmsprop",
     {"Param": P43, "Moment": _pos(4, 3), "MeanSquare": _pos(4, 3) + 0.1,
      "MeanGrad": _p(4, 3) * 0.01, "LearningRate": LR},
     {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.9, "centered": True}),
    ("ftrl_from_zero_l1_l2", "ftrl",
     {"Param": P43, "SquaredAccumulator": np.zeros((4, 3), np.float32),
      "LinearAccumulator": np.zeros((4, 3), np.float32),
      "LearningRate": LR}, {"l1": 0.1, "l2": 0.1, "lr_power": -0.5}),
    ("ftrl_l1", "ftrl",
     {"Param": P43, "SquaredAccumulator": _pos(4, 3),
      "LinearAccumulator": _p(4, 3) * 0.1, "LearningRate": LR},
     {"l1": 0.05, "l2": 0.0}),
    ("proximal_gd", "proximal_gd", {"Param": P43, "LearningRate": LR},
     {"l1": 0.05, "l2": 0.05}),
    ("proximal_adagrad", "proximal_adagrad",
     {"Param": P43, "Moment": _pos(4, 3), "LearningRate": LR},
     {"l1": 0.05, "l2": 0.05}),
    ("lamb", "lamb",
     {"Param": _p(5, 4), "Moment1": _pos(5, 4), "Moment2": _pos(5, 4),
      "Beta1Pow": np.array([0.9], np.float32),
      "Beta2Pow": np.array([0.999], np.float32), "LearningRate": LR},
     {"weight_decay": 0.01}),
    ("lamb_zero_norm_param", "lamb",
     {"Param": np.zeros((3, 2), np.float32),
      "Moment1": np.zeros((3, 2), np.float32),
      "Moment2": np.zeros((3, 2), np.float32),
      "Beta1Pow": np.array([0.9], np.float32),
      "Beta2Pow": np.array([0.999], np.float32), "LearningRate": LR},
     {"weight_decay": 0.0}),
    ("average_accumulates", "average_accumulates",
     {"param": _p(3, 2), "in_sum_1": np.zeros((3, 2), np.float32),
      "in_sum_2": _p(3, 2), "in_sum_3": _p(3, 2),
      "in_num_accumulates": np.array([0], np.int64),
      "in_old_num_accumulates": np.array([5], np.int64),
      "in_num_updates": np.array([7], np.int64)},
     {"average_window": 10, "max_average_window": 20}),
]


def _grad(state):
    p = state.get("Param", state.get("param"))
    return _p(*p.shape)


@pytest.mark.parametrize("name,type,state,attrs", CASES,
                         ids=[c[0] for c in CASES])
def test_update_matches_the_jax_lowering_over_3_steps(name, type, state,
                                                      attrs):
    jstate, tstate = dict(state), dict(state)
    for step in range(3):
        g = _grad(state)
        ins_j = {s: [v] for s, v in jstate.items()}
        ins_t = {s: [v] for s, v in tstate.items()}
        if type != "average_accumulates":
            ins_j["Grad"], ins_t["Grad"] = [g], [g]
        j, t = run_jax(type, ins_j, attrs), run_port(type, ins_t, attrs)
        assert sorted(j) == sorted(t), (step, sorted(j), sorted(t))
        same(j, t)
        for slot in j:
            jstate[_in_slot(type, slot)] = j[slot][0]
            tstate[_in_slot(type, slot)] = t[slot][0]
        if type == "adamax":   # the optimizer's scale op
            jstate["Beta1Pow"] = jstate["Beta1Pow"] * np.float32(0.9)
            tstate["Beta1Pow"] = tstate["Beta1Pow"] * np.float32(0.9)
    if type == "rmsprop" and not attrs.get("centered"):
        assert "MeanGradOut" not in t
        np.testing.assert_array_equal(tstate["MeanGrad"], state["MeanGrad"])
    if name == "lamb_zero_norm_param":
        assert np.abs(tstate["Param"]).max() > 0


def test_the_cases_cover_the_9_types_with_the_jax_flags():
    assert sorted({c[1] for c in CASES}) == sorted(TYPES)
    for t in TYPES:
        j, p = jreg.get(t), treg.get(t)
        assert (j.no_grad, tuple(j.nondiff_inputs),
                tuple(j.stateful_outputs)) == \
            (p.no_grad, tuple(p.nondiff_inputs),
             tuple(p.stateful_outputs)), t


SPARSE = [c for c in CASES if c[1] != "average_accumulates"
          and not c[0].startswith(("lamb_zero", "ftrl_l1", "rmsprop_c"))]


@pytest.mark.parametrize("name,type,state,attrs", SPARSE,
                         ids=[c[0] for c in SPARSE])
def test_a_row_sparse_gradient_raises_in_both_packages(name, type, state,
                                                       attrs):
    rows = np.array([0, 2, 0], np.int32)
    vals = _p(3, state["Param"].shape[1])
    h = state["Param"].shape[0]
    op = Op(type, attrs)
    jins = {s: [jnp.asarray(v)] for s, v in state.items()}
    jins["Grad"] = [JSparse(jnp.asarray(rows), jnp.asarray(vals), h)]
    with pytest.raises(Exception):
        jreg.get(type).lower(JCtx(key=jax.random.PRNGKey(0)).for_op(op),
                             jins, attrs, op)
    tins = {s: [torch.from_numpy(v)] for s, v in state.items()}
    tins["Grad"] = [TSparse(torch.from_numpy(rows), torch.from_numpy(vals),
                            h)]
    with pytest.raises(TypeError, match="dense gradient"):
        treg.get(type).lower(TCtx().for_op(op), tins, attrs, op)
