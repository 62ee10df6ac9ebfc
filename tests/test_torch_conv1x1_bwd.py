"""The fused 1x1-conv backward (B8) on the CPU against the JAX package:
the port's plain version against the JAX Pallas kernel in interpret mode
(``_bwd_fused``), against its two-einsum reference and against
``torch.autograd`` of the convolution, from the same numpy inputs; the
``supported`` predicate case by case; and the ``conv2d`` op with the
flag on.

Tolerances as tests/test_conv1x1_bwd.py pins them: float32 1e-5 (dw
1e-4 absolute), bfloat16 2e-2 (dw 2e-1 absolute)."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu.kernels import conv1x1_bwd as K
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lower import TraceContext as TCtx
from paddle_tpu_torch.kernels import conv1x1_bwd as tk


@pytest.fixture
def flag_on():
    tflags.set_flags({"FLAGS_fused_conv1x1_bwd": True})
    yield
    tflags.set_flags({"FLAGS_fused_conv1x1_bwd": False})


def _inputs(b, ci, co, h, w, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, ci, h, w).astype(np.float32),
            rng.randn(co, ci, 1, 1).astype(np.float32),
            rng.randn(b, co, h, w).astype(np.float32))


# the JAX test's shape; odd sizes; HW = 1
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(4, 16, 32, 8, 8), (3, 5, 7, 3, 5),
                                  (2, 8, 4, 1, 1)])
def test_plain_matches_the_pallas_kernel_and_its_reference(dims, dtype):
    x, w, dy = _inputs(*dims)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx, tw, tdy = (torch.from_numpy(a).to(tdt) for a in (x, w, dy))
    jx, jw, jdy = (jnp.asarray(a).astype(jdt) for a in (x, w, dy))
    dx, dw = tk.conv1x1_bwd(tx, tw, tdy)
    assert dx.dtype == tdt and dw.dtype == tdt
    assert dx.shape == tx.shape and dw.shape == tw.shape
    tol = 1e-5 if dtype == "float32" else 2e-2
    for jdx, jdw in (K._bwd_fused(jx, jw, jdy, interpret=True),
                     K._reference_bwd(jx, jw, jdy)):
        np.testing.assert_allclose(
            dx.float().numpy(), np.asarray(jdx.astype(jnp.float32)),
            rtol=tol, atol=tol)
        np.testing.assert_allclose(
            dw.float().numpy(), np.asarray(jdw.astype(jnp.float32)),
            rtol=tol, atol=tol * 10)


def test_plain_matches_autograd_of_the_convolution():
    x, w, dy = (torch.from_numpy(a) for a in _inputs(2, 8, 16, 4, 4, seed=3))
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(F.conv2d(xr, wr), (xr, wr), dy)
    got = tk.conv1x1_bwd_reference(x, w, dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_conv1x1_function_backward_is_the_wrapper():
    """conv1x1's forward is the convolution; its backward goes through
    ``conv1x1_bwd`` (the plain version on CPU tensors: no launch)."""
    x, w, dy = (torch.from_numpy(a) for a in _inputs(2, 6, 10, 5, 3, seed=4))
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    tk.reset_launches()
    y = tk.conv1x1(xr, wr)
    torch.testing.assert_close(y, F.conv2d(x, w))
    dx, dw = torch.autograd.grad(y, (xr, wr), dy)
    rdx, rdw = tk.conv1x1_bwd_reference(x, w, dy)
    torch.testing.assert_close(dx, rdx)
    torch.testing.assert_close(dw, rdw)
    assert tk.launches == {"conv1x1_bwd": 0}


X4 = torch.empty(4, 16, 8, 8)
W1 = torch.empty(32, 16, 1, 1)


def test_supported_needs_the_flag():
    assert tflags.get_flags("FLAGS_fused_conv1x1_bwd") == {
        "FLAGS_fused_conv1x1_bwd": False}
    assert not tk.supported(X4, W1, {})


@pytest.mark.parametrize("x,w,attrs,want", [
    (X4, W1, {}, True),
    (X4, W1, {"data_layout": "AnyLayout"}, True),
    (X4, torch.empty(32, 16, 3, 3), {}, False),                  # 3x3
    (X4, W1, {"strides": [2, 2]}, False),
    (X4, W1, {"paddings": [1, 1]}, False),
    (X4, W1, {"dilations": [2, 2]}, False),
    (X4, torch.empty(32, 8, 1, 1), {"groups": 2}, False),
    (X4, W1, {"data_layout": "NHWC"}, False),
    (torch.empty(4, 16, 8), W1, {}, False),                      # not 4-D
    # the JAX package refuses these two for their size in fast memory;
    # the port takes them
    (torch.empty(8, 256, 56, 56), torch.empty(64, 256, 1, 1), {}, True),
    (torch.empty(2, 2048, 56, 56), torch.empty(2048, 2048, 1, 1), {}, True),
], ids=["1x1", "anylayout", "3x3", "stride2", "padding", "dilation",
        "groups", "nhwc", "3d", "256to64_at_56", "huge"])
def test_supported_case_by_case(flag_on, x, w, attrs, want):
    assert tk.supported(x, w, attrs) is want
    # where the JAX package's structural rules speak, they agree
    import jax

    from paddle_tpu import flags as jflags
    jflags.set_flags({"FLAGS_fused_conv1x1_bwd": True})
    try:
        jx = jax.ShapeDtypeStruct(tuple(x.shape), jnp.float32)
        jw = jax.ShapeDtypeStruct(tuple(w.shape), jnp.float32)
        theirs = K.supported(jx, jw, attrs, interpret=True)
    finally:
        jflags.set_flags({"FLAGS_fused_conv1x1_bwd": False})
    if x.numel() < 1e5:
        assert theirs is want
    else:
        assert theirs is False and want is True


def test_flags_registry():
    with pytest.raises(KeyError, match="unknown flag"):
        tflags.set_flags({"FLAGS_no_such_flag": 1})
    assert set(tflags.get_flags()) == {"FLAGS_fused_conv1x1_bwd"}
    assert tflags._coerce(False, "Yes") is True
    assert tflags._coerce(False, "0") is False


def _conv_grad(attrs, x, w, dy):
    """The port's conv2d lowering and its generic grad."""
    spec = treg.get("conv2d")
    ctx = TCtx(device=torch.device("cpu"))
    ins = {"Input": [torch.from_numpy(x)], "Filter": [torch.from_numpy(w)]}

    fwd = types.SimpleNamespace(type="conv2d", uid=0, attrs=attrs)
    out = spec.lower(ctx, ins, attrs, fwd)["Output"]
    g = treg.generic_grad(ctx, spec, fwd, ins,
                          {"Output": [torch.from_numpy(dy)]})
    return out, g["Input"][0], g["Filter"][0]


def test_conv2d_op_routes_1x1_through_the_fused_backward(flag_on,
                                                         monkeypatch):
    x, w, dy = _inputs(2, 6, 10, 5, 3, seed=5)
    calls = []
    real = tk.conv1x1_bwd
    monkeypatch.setattr(tk, "conv1x1_bwd",
                        lambda *a: calls.append(1) or real(*a))
    attrs = {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
             "groups": 1}
    out, dx, dw = _conv_grad(attrs, x, w, dy)
    assert calls == [1]
    tflags.set_flags({"FLAGS_fused_conv1x1_bwd": False})
    out0, dx0, dw0 = _conv_grad(attrs, x, w, dy)
    assert calls == [1]                       # flag off: library backward
    torch.testing.assert_close(out, out0)
    torch.testing.assert_close(dx, dx0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw, dw0, rtol=1e-5, atol=1e-4)
    # a stride-2 1x1 conv never takes the fused path
    tflags.set_flags({"FLAGS_fused_conv1x1_bwd": True})
    _conv_grad(dict(attrs, strides=[2, 2]), x, w, dy[:, :, ::2, ::2].copy())
    assert calls == [1]
