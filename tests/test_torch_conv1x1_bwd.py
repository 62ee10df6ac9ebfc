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


# ---------------------------------------------------------------------------
# the kernel's numerical design and launch plan
# ---------------------------------------------------------------------------

def _tf32(x):
    """float32 cut to TF32's 10 mantissa bits through the int32 view: the
    kernel's split of a big part, and what the tensor core does with the
    rest of a float32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b from the kernel's operand split: each operand split into
    big = tf32(v) and small = v - big (which the tensor core cuts to
    TF32 too), the products small*big + big*small + big*big summed by an
    IEEE float32 matmul. This models the split only: the tensor core's
    own accumulation truncates, which _chain_3xtf32 models."""
    ab, bb = _tf32(a), _tf32(b)
    return _tf32(a - ab) @ bb + ab @ _tf32(b - bb) + ab @ bb


def _rz32(v):
    """float64 to float32 rounded toward zero."""
    f = v.float()
    over = f.double().abs() > v.abs()
    return torch.where(over, (f.view(torch.int32) - 1).view(torch.float32),
                       f)


def _chain_3xtf32(a, b, chunk, stage):
    """a^T b for a [j, M], b [j, N] the way the kernel's dw role forms
    it, with a model of the tensor core's accumulation: the depth in
    chunks of ``chunk``, each a chain of m16n8k8 products (8 deep, the
    three of 3xTF32 in turn) where every product's sum with the
    accumulator is rounded toward zero to float32; with ``stage`` set,
    each stage's chain starts from zero and is added to the chunk's sum
    in float32 (round to nearest), as the kernel does with its 32-deep
    stages. The chunks' sums are added in order in float32."""
    s = a.shape[0] // chunk
    A = a.reshape(s, chunk, -1).transpose(1, 2)
    B = b.reshape(s, chunk, -1)
    Ab, Bb = _tf32(A), _tf32(B)
    As, Bs = _tf32(A - Ab), _tf32(B - Bb)
    acc = part = torch.zeros(s, A.shape[1], B.shape[2])
    for k in range(0, chunk, 8):
        sl = slice(k, k + 8)
        for x, y in ((As, Bb), (Ab, Bs), (Ab, Bb)):
            part = _rz32(part.double()
                         + x[:, :, sl].double() @ y[:, sl, :].double())
        if stage and (k + 8) % stage == 0:
            acc, part = acc + part, torch.zeros_like(part)
    acc = acc + part
    out = torch.zeros_like(acc[0])
    for i in range(s):
        out = out + acc[i]
    return out


# the path's float32 tolerance (chip_smoke.py C1_RTOL, C1_AMAX)
C1_RTOL, C1_AMAX = 1e-4, 2e-5


def _within(got, truth):
    err = (got.double() - truth).abs()
    return bool((err <= C1_AMAX * truth.abs().max()
                 + C1_RTOL * truth.abs()).all())


def test_3xtf32_keeps_dw_within_the_float32_tolerance_one_tf32_pass_does_not():
    """dw at 64 -> 64 over B*HW = 200704 positions (64 images of 56x56),
    the path's deepest sum: the 3xTF32 split, summed in IEEE float32,
    lands as close to float64 as float32 products do; one TF32 product
    per term does not. The split only: the card's accumulation is the
    next test's."""
    rng = np.random.RandomState(0)
    j = 64 * 56 * 56
    dy = torch.from_numpy(rng.randn(j, 64).astype(np.float32))
    x = torch.from_numpy(rng.randn(j, 64).astype(np.float32))
    truth = dy.double().T @ x.double()
    dyt = dy.T.contiguous()

    def err(got):   # of max|dw|
        return float((got.double() - truth).abs().max()
                     / truth.abs().max())

    fp32, x3, x1 = dyt @ x, _mm_3xtf32(dyt, x), _tf32(dyt) @ _tf32(x)
    assert _within(fp32, truth) and err(fp32) < 1e-6
    assert _within(x3, truth) and err(x3) < 1e-6
    assert not _within(x1, truth) and err(x1) > 1e-4


def test_truncating_accumulation_drifts_with_the_chain_stage_sums_do_not():
    """Why the kernel adds each 32-deep stage's products into a fresh
    accumulator: with the tensor core's accumulation modelled as rounding
    toward zero, dw over 200704 positions (32 -> 32 channels, to keep the
    model quick) in 1024-position chunks drifts over ten times further
    from float64 than float32 products do, and further the longer the
    chain; summing each stage's chain in float32 brings it back. The
    card's own numbers are chip_smoke.py's sweep over chunk lengths."""
    rng = np.random.RandomState(0)
    j = 64 * 56 * 56
    dy = torch.from_numpy(rng.randn(j, 32).astype(np.float32))
    x = torch.from_numpy(rng.randn(j, 32).astype(np.float32))
    truth = dy.double().T @ x.double()

    def err(got):   # of max|dw|
        return float((got.double() - truth).abs().max()
                     / truth.abs().max())

    fp32 = err(dy.T.contiguous() @ x)
    long_chain = err(_chain_3xtf32(dy, x, 1024, None))
    longer = err(_chain_3xtf32(dy, x, 4096, None))
    staged_dw = _chain_3xtf32(dy, x, 1024, tk.STAGE_K)
    staged = err(staged_dw)
    assert long_chain > 10 * fp32 and longer > 2 * long_chain
    assert staged < 4 * fp32 and staged < long_chain / 4
    assert _within(staged_dw, truth)


# every distinct (Ci, H, W, Co) of ResNet-50's fusable 1x1 convolutions at
# 224x224, with its count a step (test_path_shapes_are_the_programs)
PATH_SHAPES = {(64, 56, 56, 256): 4, (64, 56, 56, 64): 1,
               (256, 56, 56, 64): 2, (128, 28, 28, 512): 4,
               (512, 28, 28, 128): 3, (256, 14, 14, 1024): 6,
               (1024, 14, 14, 256): 5, (512, 7, 7, 2048): 3,
               (2048, 7, 7, 512): 2}
PLAN_CASES = [(64,) + s for s in PATH_SHAPES] + [(3, 24, 5, 7, 40)]


def test_path_shapes_are_the_programs():
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models.resnet import build_resnet50_train

    with unique_name.guard():
        prog = build_resnet50_train(layout="NCHW")[0]
    block = prog.global_block()
    got = {}
    for op in block.ops:
        if op.type != "conv2d":
            continue
        w = block.var(op.input("Filter")[0]).shape
        a = op.attrs
        if tuple(w[2:]) == (1, 1) and list(a["strides"]) == [1, 1] \
                and not any(a["paddings"]):
            x = block.var(op.input("Input")[0]).shape
            key = (x[1], x[2], x[3], w[0])
            got[key] = got.get(key, 0) + 1
    assert got == PATH_SHAPES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,ci,h,w,co", PLAN_CASES)
def test_plan_covers_the_depth_in_whole_stages(b, ci, h, w, co, dtype):
    size = torch.empty((), dtype=dtype).element_size()
    hw, j = h * w, b * h * w
    p = tk.plan(b, ci, co, hw, size)
    # the chunks cover B*HW exactly, none is empty, each is whole stages
    assert p.chunk % tk.STAGE_K == 0 and p.chunk > 0
    assert p.splits * p.chunk >= j > (p.splits - 1) * p.chunk
    # tiles: 128 where the channels reach it
    assert p.ci_tile == (64 if ci <= 64 else 128)
    assert p.co_tile == (64 if co <= 64 else 128)
    tiles = -(-ci // p.ci_tile) * -(-co // p.co_tile)
    # two-level sum: groups of about sqrt(splits), a ticket per group and
    # one for the groups, per tile
    assert (p.group - 1) ** 2 < p.splits <= p.group ** 2
    assert p.tickets == tiles * (-(-p.splits // p.group) + 1)
    # the partial sums stay under half of x's and dy's elements
    if p.splits > 1:
        assert p.splits * co * ci <= j * (ci + co) // 2
    # 16-byte copies exactly where every staged row starts on a 16-byte
    # boundary
    assert p.vec == ((hw * size) % 16 == 0 and (ci * size) % 16 == 0)
    assert not tk.plan(b, ci, co, hw, size, aligned=False).vec


def test_plan_stages_the_path_as_the_kernel_notes_say():
    """56x56 .. 14x14 rows take 16-byte copies, 7x7 (196-byte rows) and
    the odd test shape 4-byte ones; chunks of about 1024 positions where
    the partial sums' cap allows, and two blocks an SM or more in all."""
    for (ci, h, w, co) in PATH_SHAPES:
        j = 64 * h * w
        p = tk.plan(64, ci, co, h * w)
        assert p.vec == (h != 7)
        tiles = -(-ci // p.ci_tile) * -(-co // p.co_tile)
        n_dx = -(-ci // p.ci_tile) * -(-j // tk.DX_BN)
        cap = j * (ci + co) // (2 * co * ci)
        assert p.chunk <= 1024 or p.splits == cap
        assert n_dx + tiles * p.splits >= 2 * 132
    assert not tk.plan(3, 24, 40, 35).vec


def test_plan_orders_the_roles_by_where_x_and_dy_live():
    """Interleaved where x and dy exceed what stays in L2 (the dx and dw
    blocks of one stretch of positions share its dy tiles); at 7x7, where
    both stay in L2, the role with the longer blocks goes first."""
    for (ci, h, w, co) in PATH_SHAPES:
        p = tk.plan(64, ci, co, h * w)
        if h > 7:
            assert p.order == tk.INTERLEAVE
            continue
        dx_block = p.ci_tile * tk.DX_BN * co
        dw_block = p.co_tile * p.ci_tile * p.chunk
        assert p.order == (tk.DX_FIRST if dx_block >= dw_block
                           else tk.DW_FIRST)
    assert tk.plan(64, 512, 2048, 49).order == tk.DX_FIRST
    assert tk.plan(64, 2048, 512, 49).order == tk.DW_FIRST
