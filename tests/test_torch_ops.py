"""Each op lowering of the port against the JAX package's lowering of the
same op, on identical numpy inputs (tolerance 1e-5 for float results:
fp32 math in another summation order; integer and shape results exact).
The three ``fused_attention`` modes also compare the updated caches."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu_torch  # noqa: F401  (registers the port's lowerings)
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.lower import TraceContext as JCtx
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.lower import TraceContext as TCtx

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

TOL = 1e-5


class _Op:
    """The slice of an Operator a lowering reads."""

    def __init__(self, type, attrs, uid=1):
        self.type, self.attrs, self.uid = type, attrs, uid
        self.inputs, self.outputs = {}, {}


def _run_both(type, ins, attrs, uid=1):
    """ins: {slot: [numpy arrays]} -> ({slot: [numpy]} jax, port)."""
    op = _Op(type, attrs, uid)
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    jout = jreg.normalize_outputs(jreg.get(type).lower(
        JCtx(key=jax.random.PRNGKey(0)).for_op(op), jins, attrs, op))
    tins = {s: [torch.from_numpy(np.array(a)) for a in v]
            for s, v in ins.items()}
    tout = treg.normalize_outputs(treg.get(type).lower(
        TCtx(key=0).for_op(op), tins, attrs, op))

    def host(d):
        return {s: [None if x is None else np.asarray(x) for x in v]
                for s, v in d.items()}

    return host(jout), {s: [None if x is None else x.numpy() for x in v]
                        for s, v in tout.items()}


def _assert_same(j, t, slots=None):
    for slot in slots or j:
        for a, b in zip(j[slot], t[slot]):
            if a is None:
                assert b is None
                continue
            assert a.shape == b.shape, (slot, a.shape, b.shape)
            if np.issubdtype(a.dtype, np.floating):
                np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
            else:
                np.testing.assert_array_equal(b, a)
                assert b.dtype == a.dtype, (slot, b.dtype, a.dtype)


def _f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


RNG = np.random.RandomState(0)


def test_position_ids():
    j, t = _run_both("position_ids",
                     {"X": [RNG.randint(0, 9, (3, 5)).astype(np.int64)]}, {})
    _assert_same(j, t)
    assert t["Out"][0].dtype == np.int32


@pytest.mark.parametrize("shape", [[0, 0, 2, 2], [-1, 4], [0, 8]])
def test_reshape(shape):
    x = _f32(RNG, 6, 2, 4)
    j, t = _run_both("reshape", {"X": [x]}, {"shape": shape})
    _assert_same(j, t)


def test_transpose():
    j, t = _run_both("transpose", {"X": [_f32(RNG, 2, 3, 4, 5)]},
                     {"axis": [0, 2, 1, 3]})
    _assert_same(j, t)


def test_unsqueeze():
    j, t = _run_both("unsqueeze",
                     {"X": [np.arange(4, dtype=np.int32)]},
                     {"axes": [2, 1]})
    _assert_same(j, t)
    assert t["Out"][0].shape == (4, 1, 1)


@pytest.mark.parametrize("dtype,value", [("float32", 1.0),
                                         ("float32", 0.0),
                                         ("int32", 3)])
def test_fill_constant(dtype, value):
    j, t = _run_both("fill_constant", {}, {"shape": [3, 2], "dtype": dtype,
                                          "value": value})
    _assert_same(j, t)


def test_uniform_random_range_shape_and_streams():
    """The two packages draw different numbers (torch.Generator vs
    jax.random); the contract is shape, dtype, range, and a stream that
    is a function of (step key, op uid, seed attr)."""
    attrs = {"shape": [64, 32], "dtype": "float32", "min": -0.25,
             "max": 0.25, "seed": 0}
    j, t = _run_both("uniform_random", {}, attrs)
    a, b = j["Out"][0], t["Out"][0]
    assert a.shape == b.shape == (64, 32) and b.dtype == a.dtype
    assert b.min() >= -0.25 and b.max() < 0.25 and b.std() > 0.1
    again = _run_both("uniform_random", {}, attrs)[1]["Out"][0]
    other_op = _run_both("uniform_random", {}, attrs, uid=2)[1]["Out"][0]
    salted = _run_both("uniform_random", {}, dict(attrs, seed=7))[1]
    np.testing.assert_array_equal(again, b)
    assert not np.array_equal(other_op, b)
    assert not np.array_equal(salted["Out"][0], b)


@pytest.mark.parametrize("xshape,xd", [((2, 3, 8), 2), ((4, 8), 1),
                                       ((2, 3, 2, 4), 2)])
def test_mul(xshape, xd):
    x = _f32(RNG, *xshape)
    k = int(np.prod(xshape[xd:]))
    j, t = _run_both("mul", {"X": [x], "Y": [_f32(RNG, k, 5)]},
                     {"x_num_col_dims": xd, "y_num_col_dims": 1})
    _assert_same(j, t)


@pytest.mark.parametrize("yshape,axis", [((2, 3, 8), -1), ((8,), 2),
                                         ((2, 3, 1), -1), ((1, 3, 8), -1)])
def test_elementwise_add(yshape, axis):
    j, t = _run_both("elementwise_add",
                     {"X": [_f32(RNG, 2, 3, 8)], "Y": [_f32(RNG, *yshape)]},
                     {"axis": axis})
    _assert_same(j, t)


def test_gelu_exact_erf_form():
    x = np.linspace(-6, 6, 97).astype(np.float32).reshape(1, 97)
    j, t = _run_both("gelu", {"X": [x]}, {})
    _assert_same(j, t)


@pytest.mark.parametrize("ids_shape,pad", [((3, 5), -1), ((4, 1, 1), -1),
                                           ((2, 6), 3)])
def test_lookup_table(ids_shape, pad):
    w = _f32(RNG, 11, 6)
    ids = RNG.randint(0, 11, ids_shape).astype(np.int64)
    if pad >= 0:
        ids.flat[0] = pad
    j, t = _run_both("lookup_table", {"W": [w], "Ids": [ids]},
                     {"padding_idx": pad, "is_sparse": False})
    _assert_same(j, t)
    if pad >= 0:
        assert not t["Out"][0][0, 0].any()


@pytest.mark.parametrize("shape", [(2, 5, 16), (1, 1, 16), (3, 1, 16)])
def test_layer_norm_y_mean_variance(shape):
    x = _f32(RNG, *shape) * 3 + 1
    j, t = _run_both("layer_norm", {"X": [x], "Scale": [_f32(RNG, 16)],
                                    "Bias": [_f32(RNG, 16)]},
                     {"epsilon": 1e-5, "begin_norm_axis": 2})
    _assert_same(j, t, ["Y", "Mean", "Variance"])


# ---- fused_attention, all three modes ----

def _qkv(b, h, s, d):
    return [_f32(RNG, b, h, s, d) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_fused_attention_one_shot(causal):
    q, k, v = _qkv(2, 4, 12, 8)
    j, t = _run_both("fused_attention", {"Q": [q], "K": [k], "V": [v]},
                     {"causal": causal, "scale": None, "seq_axis": None,
                      "batch_axis": None})
    _assert_same(j, t)


def test_fused_attention_one_shot_segments():
    q, k, v = _qkv(2, 2, 16, 8)
    seg = np.sort(RNG.randint(0, 3, (2, 16)), axis=1).astype(np.int32)
    j, t = _run_both("fused_attention",
                     {"Q": [q], "K": [k], "V": [v], "QSeg": [seg],
                      "KSeg": [seg]},
                     {"causal": True, "scale": None, "seq_axis": None,
                      "batch_axis": None})
    _assert_same(j, t)


def test_fused_attention_prefill_writes_cache_row():
    slots, h, max_len, d, n = 3, 4, 32, 8, 8
    q, k, v = _qkv(1, h, n, d)
    kc, vc = _f32(RNG, slots, h, max_len, d), _f32(RNG, slots, h, max_len, d)
    j, t = _run_both("fused_attention",
                     {"Q": [q], "K": [k], "V": [v], "KCache": [kc],
                      "VCache": [vc], "Slot": [np.asarray([2], np.int32)]},
                     {"causal": True, "scale": None, "seq_axis": None,
                      "batch_axis": None, "cache_mode": "prefill"})
    _assert_same(j, t, ["Out", "KCacheOut", "VCacheOut"])
    np.testing.assert_array_equal(t["KCacheOut"][0][2, :, :n], k[0])
    np.testing.assert_array_equal(t["VCacheOut"][0][:2], vc[:2])


def test_fused_attention_decode_scatters_and_reads_prefix():
    slots, h, max_len, d = 3, 4, 32, 8
    q, k, v = _qkv(slots, h, 1, d)
    kc, vc = _f32(RNG, slots, h, max_len, d), _f32(RNG, slots, h, max_len, d)
    pos = np.asarray([0, 17, 31], np.int32)
    j, t = _run_both("fused_attention",
                     {"Q": [q], "K": [k], "V": [v], "KCache": [kc],
                      "VCache": [vc], "Pos": [pos]},
                     {"causal": True, "scale": None, "seq_axis": None,
                      "batch_axis": None, "cache_mode": "decode"})
    _assert_same(j, t, ["Out", "KCacheOut", "VCacheOut"])
    np.testing.assert_array_equal(t["KCacheOut"][0][1, :, 17], k[1, :, 0])


def test_fused_attention_cache_updates_in_place():
    """The cache inputs are updated in place and re-emitted (where the
    JAX package donates the buffers through the call)."""
    q, k, v = (torch.randn(2, 2, 1, 8) for _ in range(3))
    kc, vc = torch.zeros(2, 2, 16, 8), torch.zeros(2, 2, 16, 8)
    op = _Op("fused_attention", {"causal": True, "cache_mode": "decode"})
    out = treg.get("fused_attention").lower(
        TCtx().for_op(op), {"Q": [q], "K": [k], "V": [v], "KCache": [kc],
                            "VCache": [vc],
                            "Pos": [torch.tensor([3, 5], dtype=torch.int32)]},
        op.attrs, op)
    assert out["KCacheOut"] is kc and out["VCacheOut"] is vc
    torch.testing.assert_close(kc[1, :, 5], k[1, :, 0])


def test_fused_attention_seq_axis_without_a_mesh_is_plain_attention():
    """``seq_axis`` names a mesh axis: with no parallel executor's mesh
    (no comm layer) the op is plain attention, bit for bit, as the JAX
    op is without ``ctx.mesh``."""
    q, k, v = (torch.randn(1, 2, 16, 8) for _ in range(3))
    outs = []
    for attrs in ({"causal": True}, {"causal": True, "seq_axis": "sp"}):
        op = _Op("fused_attention", attrs)
        outs.append(treg.get("fused_attention").lower(
            TCtx().for_op(op), {"Q": [q], "K": [k], "V": [v]}, attrs,
            op)["Out"])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("attrs,err", [
    ({"causal": True, "cache_mode": "decode", "seq_axis": "sp"},
     ValueError),
    ({"causal": False, "cache_mode": "prefill"}, ValueError),
    ({"causal": True, "cache_mode": "prefill", "seq_axis": "sp"},
     ValueError),
])
def test_fused_attention_loud_errors(attrs, err):
    x = torch.randn(1, 2, 4, 8)
    ins = {"Q": [x], "K": [x], "V": [x], "KCache": [torch.zeros(1, 2, 8, 8)],
           "VCache": [torch.zeros(1, 2, 8, 8)],
           "Pos": [torch.zeros(1, dtype=torch.int32)],
           "Slot": [torch.zeros(1, dtype=torch.int32)]}
    if "cache_mode" not in attrs:
        ins = {s: ins[s] for s in ("Q", "K", "V")}
    op = _Op("fused_attention", attrs)
    with pytest.raises(err):
        treg.get("fused_attention").lower(TCtx().for_op(op), ins, attrs, op)
