"""The recurrent kernels' plain versions and the recurrent models under
bf16 AMP, on the CPU, against the JAX package.

* Kernel level: the port's plain B3/B4 (LSTM) and B5/B6 (GRU) on
  bfloat16 inputs against the JAX Pallas kernels in interpret mode
  (``lstm_sequence(..., interpret=True)``, ``gru_sequence(...,
  interpret=True)`` and ``jax.vjp`` through them): the same numpy inputs
  from a seed, ragged masks, peepholes on and off. Both keep the carried
  state, the gates and every sum in float32 and round h_{t-1} (and the
  GRU's r h_{t-1}, the backward's dgates, da_c, da_ur) to bfloat16 just
  before each recurrent product; they differ in the products' summation
  order. hs, cs and every gradient are held within relative L2 2e-3
  (measured: at most 1.2e-5 for the LSTM, 3.2e-4 for the GRU).
* The float32-state witness: the port's bf16 hs lies no farther from its
  float32 hs than 1.25 times the JAX kernel's does from its own
  (measured 1.00 for both; the port's plain versions carried their state
  in bfloat16 before, 2.33x).
* Whole models under ``amp.enable``: the stacked LSTM (dict 100, emb
  and hid 64, 3 layers, batch 8, T 16) and seq2seq (hid 32, batch 4)
  from the JAX startup's weights (``interop.load_reference_state``),
  equal lengths (a reverse JAX LSTM or GRU zeroes position 0 of shorter
  rows). The JAX package runs its jnp step loops here, which do not
  round h before the product, so the bounds are the AMP bounds of
  tests/test_torch_amp.py: 3 steps' losses within rtol 1e-2; each
  first-step gradient within 0.5 of its own L2 norm, all together
  within 0.2; the port's bf16 gradients no farther from its float32
  ones than 1.25 times the JAX package's; master parameters float32,
  and their gradients too but for the embeddings' (bfloat16 in both
  packages).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import amp as jamp
from paddle_tpu import unique_name as jnames
from paddle_tpu.kernels import gru_cell as jgru
from paddle_tpu.kernels import lstm_cell as jlstm_cell
from paddle_tpu.models import seq2seq as jseq
from paddle_tpu.models import stacked_lstm as jlstm
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import interop
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.kernels import gru_cell as tgru
from paddle_tpu_torch.kernels import lstm_cell as tlstm_cell
from paddle_tpu_torch.models import seq2seq as tseq
from paddle_tpu_torch.models import stacked_lstm as tlstm

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

CPU = tfluid.CPUPlace()
BF16 = torch.bfloat16
KERNEL_L2 = 2e-3
WITNESS = 1.25


def _rl2(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(t):
    """A torch or JAX array as float64 numpy (bfloat16 widened)."""
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32), np.float64)


def _mask(rng, B, T):
    lens = rng.randint(1, T + 1, B)
    lens[0], lens[-1] = T, 1
    return (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)


def _lstm_inputs(B, T, H, peep, seed=0):
    rng = np.random.RandomState(seed)
    xg = rng.randn(B, T, 4 * H).astype(np.float32) * 0.5
    w = rng.randn(H, 4 * H).astype(np.float32) * H ** -0.5
    h0 = rng.randn(B, H).astype(np.float32) * 0.1
    c0 = rng.randn(B, H).astype(np.float32) * 0.1
    p = (rng.randn(3, H).astype(np.float32) * 0.1 if peep
         else np.zeros((3, H), np.float32))
    dhs = rng.randn(B, T, H).astype(np.float32)
    dcs = rng.randn(B, T, H).astype(np.float32)
    return xg, w, h0, c0, _mask(rng, B, T), p, dhs, dcs


def _jax_lstm(xg, w, h0, c0, mask, p, dhs, dcs, dtype):
    """The JAX kernel in interpret mode: (hs, cs) and the gradients of
    (xg, w, peep, h0, c0) for cotangents (dhs, dcs)."""
    cast = [jnp.asarray(a, dtype) for a in (xg, w, h0, c0)]

    def f(xg, w, p, h0, c0):
        return jlstm_cell.lstm_sequence(xg, w, h0, c0, jnp.asarray(mask), p,
                                        interpret=True)

    out, vjp = jax.vjp(f, cast[0], cast[1], jnp.asarray(p), cast[2],
                       cast[3])
    return out, vjp((jnp.asarray(dhs, dtype), jnp.asarray(dcs, dtype)))


def _port_lstm(xg, w, h0, c0, mask, p, dhs, dcs, dtype):
    leaves = [torch.tensor(a).to(dtype).requires_grad_()
              for a in (xg, w, h0, c0)]
    pt = torch.tensor(p).requires_grad_()
    hs, cs = tlstm_cell.lstm_sequence(leaves[0], leaves[1], leaves[2],
                                      leaves[3], torch.tensor(mask), pt)
    grads = torch.autograd.grad(
        (hs, cs), [leaves[0], leaves[1], pt, leaves[2], leaves[3]],
        (torch.tensor(dhs).to(dtype), torch.tensor(dcs).to(dtype)))
    return (hs, cs), grads


LSTM_NAMES = ("hs", "cs", "dxg", "dw", "dpeep", "dh0", "dc0")


@pytest.mark.parametrize("plan, h", [("cluster", 64), ("grid", 60)])
@pytest.mark.parametrize("peep", [True, False])
def test_lstm_bf16_plain_matches_the_jax_kernel(peep, plan, h):
    """B3 and B4's plain versions in bf16 against the JAX kernels in
    interpret mode, forward and backward, every output's dtype
    included, in each plan's blocking: H 64 takes the cluster kernels'
    (lstm_cluster.cu: k16 steps, partials by block in rank order), H 60
    (not a multiple of 8) lstm_cell.cu's."""
    assert tlstm_cell.cluster_plan(8, h)["take"] == (plan == "cluster")
    args = _lstm_inputs(8, 12, h, peep)
    (jhs, jcs), jg = _jax_lstm(*args, jnp.bfloat16)
    (ths, tcs), tg = _port_lstm(*args, BF16)
    assert [t.dtype for t in (ths, tcs) + tuple(tg)] == \
        [BF16] * 4 + [torch.float32] + [BF16] * 2
    for name, got, want in zip(LSTM_NAMES, (ths, tcs) + tuple(tg),
                               (jhs, jcs) + tuple(jg)):
        assert _rl2(_np(got), _np(want)) < KERNEL_L2, name


def test_lstm_bf16_state_stays_float32():
    """The port's bf16 hs lies as far from its float32 hs as the JAX
    kernel's does (within 1.25x; 2.33x with a bf16 state)."""
    args = _lstm_inputs(8, 16, 128, True, seed=1)
    (j32, _), _ = _jax_lstm(*args, jnp.float32)
    (j16, _), _ = _jax_lstm(*args, jnp.bfloat16)
    (t32, _), _ = _port_lstm(*args, torch.float32)
    (t16, _), _ = _port_lstm(*args, BF16)
    jdist = _rl2(_np(j16), _np(j32))
    tdist = _rl2(_np(t16), _np(t32))
    assert tdist < WITNESS * jdist, (tdist, jdist)


def _gru_inputs(B, T, H, seed=0):
    rng = np.random.RandomState(seed)
    xg = rng.randn(B, T, 3 * H).astype(np.float32) * 0.5
    w = rng.randn(H, 3 * H).astype(np.float32) * H ** -0.5
    h0 = rng.randn(B, H).astype(np.float32) * 0.1
    dhs = rng.randn(B, T, H).astype(np.float32)
    return xg, w, h0, _mask(rng, B, T), dhs


def _jax_gru(xg, w, h0, mask, dhs, dtype):
    def f(xg, w, h0):
        return jgru.gru_sequence(xg, w, h0, jnp.asarray(mask), interpret=True)

    out, vjp = jax.vjp(f, *(jnp.asarray(a, dtype) for a in (xg, w, h0)))
    return out, vjp(jnp.asarray(dhs, dtype))


def _port_gru(xg, w, h0, mask, dhs, dtype):
    leaves = [torch.tensor(a).to(dtype).requires_grad_()
              for a in (xg, w, h0)]
    hs = tgru.gru_sequence(leaves[0], leaves[1], leaves[2],
                           torch.tensor(mask))
    return hs, torch.autograd.grad(hs, leaves, torch.tensor(dhs).to(dtype))


@pytest.mark.parametrize("plan, shape", [("cluster", (8, 12, 64)),
                                         ("cluster", (5, 7, 40)),
                                         ("grid", (5, 7, 36))])
def test_gru_bf16_plain_matches_the_jax_kernel(plan, shape):
    """B5 and B6's plain versions in bf16 against the JAX kernels in
    interpret mode, in each plan's blocking: H 64 and 40 (no multiple of
    16, the kernels' k16 step) take the cluster kernels' (gru_cluster.cu:
    K split over two warpgroups in k16 steps, partials by block in rank
    order), H 36 (not a multiple of 8) gru_cell.cu's."""
    assert tgru.cluster_plan(shape[0], shape[2])["take"] == (plan == "cluster")
    args = _gru_inputs(*shape)
    jhs, jg = _jax_gru(*args, jnp.bfloat16)
    ths, tg = _port_gru(*args, BF16)
    assert [t.dtype for t in (ths,) + tuple(tg)] == [BF16] * 4
    for name, got, want in zip(("hs", "dxg", "dw", "dh0"),
                               (ths,) + tuple(tg), (jhs,) + tuple(jg)):
        assert _rl2(_np(got), _np(want)) < KERNEL_L2, name


def test_gru_bf16_state_stays_float32():
    args = _gru_inputs(8, 16, 128, seed=1)
    j32, _ = _jax_gru(*args, jnp.float32)
    j16, _ = _jax_gru(*args, jnp.bfloat16)
    t32, _ = _port_gru(*args, torch.float32)
    t16, _ = _port_gru(*args, BF16)
    jdist = _rl2(_np(j16), _np(j32))
    tdist = _rl2(_np(t16), _np(t32))
    assert tdist < WITNESS * jdist, (tdist, jdist)


def test_bf16_witness_rounds_like_the_bf16_plain_version():
    """The float64 witness chip_smoke.py holds the bf16 kernels against:
    the plain versions in float64 with ``rounding=torch.bfloat16`` make
    the bf16 plain versions' roundings, so on bf16 inputs they agree to
    the float32 sums' rounding, and their outputs are bf16 values."""
    xg, w, h0, c0, mask, p, dhs, dcs = (torch.from_numpy(a) for a in
                                        _lstm_inputs(6, 9, 48, True))
    xg, w, dhs, dcs = (t.to(BF16) for t in (xg, w, dhs, dcs))
    hs, cs, st = tlstm_cell.lstm_forward_reference(xg, w, h0, c0, mask, p)
    whs, wcs, wst = tlstm_cell.lstm_forward_reference(
        xg.double(), w.double(), h0.double(), c0.double(), mask.double(),
        p.double(), rounding=BF16)
    for a, b in ((hs, whs), (st, wst)):
        assert torch.equal(b.to(BF16).double(), b)
        assert _rl2(_np(a), _np(b)) < 1e-4
    assert _rl2(_np(cs), _np(wcs)) < 1e-5
    got = tlstm_cell.lstm_backward_reference(st, cs, w, p, c0, mask, dhs, dcs)
    want = tlstm_cell.lstm_backward_reference(
        wst, wcs, w.double(), p.double(), c0.double(), mask.double(),
        dhs.double(), dcs.double(), rounding=BF16)
    for a, b in zip(got, want):
        assert _rl2(_np(a), _np(b)) < 1e-4
    xg, w, h0, mask, dhs = (torch.from_numpy(a) for a in _gru_inputs(6, 9, 48))
    xg, w, dhs = (t.to(BF16) for t in (xg, w, dhs))
    hs, st = tgru.gru_forward_reference(xg, w, h0, mask)
    whs, wst = tgru.gru_forward_reference(xg.double(), w.double(),
                                          h0.double(), mask.double(),
                                          rounding=BF16)
    for a, b in ((hs, whs), (st, wst)):
        assert torch.equal(b.to(BF16).double(), b)
        assert _rl2(_np(a), _np(b)) < 1e-4
    got = tgru.gru_backward_reference(st, hs, w, h0, mask, dhs)
    want = tgru.gru_backward_reference(wst, whs, w.double(), h0.double(),
                                       mask.double(), dhs.double(),
                                       rounding=BF16)
    for a, b in zip(got, want):
        assert _rl2(_np(a), _np(b)) < 1e-4


# ---- whole models under AMP ----

LSTM_MODEL = dict(dict_dim=100, emb_dim=64, hid_dim=64, stacked_num=3)
S2S_MODEL = dict(src_vocab=50, tgt_vocab=50, emb_dim=32, hidden_dim=32)


def _lstm_feed(B=8, T=16, seed=7):
    rng = np.random.RandomState(seed)
    return {"words": [rng.randint(1, LSTM_MODEL["dict_dim"], (T, 1))
                      .astype(np.int64) for _ in range(B)],
            "label": rng.randint(0, 2, (B, 1)).astype(np.int64)}


def _s2s_feed(B=4, T=7, seed=7):
    rng = np.random.RandomState(seed)
    tgt = [rng.randint(2, S2S_MODEL["tgt_vocab"], (n, 1)).astype(np.int64)
           for n in (6, 3, 7, 1)[:B]]
    # equal source lengths: the JAX reverse GRU zeroes position 0 of a
    # shorter row, the decoder's initial state
    return {"src_ids": [rng.randint(2, S2S_MODEL["src_vocab"], (T, 1))
                        .astype(np.int64) for _ in range(B)],
            "tgt_ids": tgt,
            "tgt_next_ids": [np.roll(t, -1, axis=0) for t in tgt]}


def _lstm_build(pkg):
    mod = jlstm if pkg == "jax" else tlstm
    prog, startup, _, (loss, _) = mod.build_stacked_lstm_train(**LSTM_MODEL)
    return prog, startup, loss


def _s2s_build(pkg):
    mod = jseq if pkg == "jax" else tseq
    prog, startup, _, (loss,) = mod.build_seq2seq(**S2S_MODEL)
    return prog, startup, loss


def _run(build, feed, amp, steps):
    """Both packages from the JAX startup's weights: the losses of
    ``steps`` steps and the first step's gradients (float64 numpy), by
    sorted parameter name. On the way: the port's masters stay float32,
    and its gradients have the JAX package's dtypes (float32, but the
    embeddings' bfloat16 under AMP in both: the hand-written
    ``lookup_table`` grad; Adam widens it)."""
    with jnames.guard():
        jprog, jstart, jloss = build("jax")
    with tnames.guard():
        tprog, tstart, tloss = build("port")
    if amp:
        jamp.enable(jprog)
        tamp.enable(tprog)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, [tprog, tstart])
    texe = tfluid.Executor(CPU)
    params = sorted(p.name for p in jprog.global_block().all_parameters())
    grads = [p + "@GRAD" for p in params]
    out = {"jax": [[], None], "port": [[], None]}
    for step in range(steps):
        extra = grads if step == 0 else []
        jout = jexe.run(jprog, feed=feed, fetch_list=[jloss.name] + extra,
                        scope=jscope)
        tout = texe.run(tprog, feed=feed, fetch_list=[tloss.name] + extra,
                        scope=tscope, return_numpy=False)
        out["jax"][0].append(float(np.asarray(jout[0])))
        out["port"][0].append(float(tout[0]))
        if step == 0:
            assert [str(g.dtype) for g in tout[1:]] == [
                "torch." + str(g.dtype) for g in jout[1:]]
            assert all(g.dtype == torch.float32 for p, g in
                       zip(params, tout[1:]) if "emb" not in p)
            out["jax"][1] = [np.asarray(g, np.float64) for g in jout[1:]]
            out["port"][1] = [g.double().numpy() for g in tout[1:]]
    assert all(tscope.find_var(p).dtype == torch.float32 for p in params)
    return params, out


def _l2(got, want):
    num = sum(float(((g - w) ** 2).sum()) for g, w in zip(got, want))
    return (num / sum(float((w ** 2).sum()) for w in want)) ** 0.5


@pytest.mark.parametrize("model", ["stacked_lstm", "seq2seq"])
def test_recurrent_models_under_amp_match_jax(model):
    build, feed = ((_lstm_build, _lstm_feed()) if model == "stacked_lstm"
                   else (_s2s_build, _s2s_feed()))
    names, half = _run(build, feed, True, 3)
    _, full = _run(build, feed, False, 1)
    (jl, jg), (tl, tg) = half["jax"], half["port"]
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    each = [_rl2(g, w) for g, w in zip(tg, jg)]
    assert max(each) < 0.5, names[int(np.argmax(each))]
    assert _l2(tg, jg) < 0.2
    # each package's distance from its own float32 gradients
    jdist = _l2(jg, full["jax"][1])
    tdist = _l2(tg, full["port"][1])
    assert tdist < WITNESS * jdist, (tdist, jdist)
    assert _l2(full["port"][1], full["jax"][1]) < 1e-4
