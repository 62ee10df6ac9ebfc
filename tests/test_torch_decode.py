"""The slice end to end on the CPU: the port's transformer LM and its
KV-cached decode serving against the JAX package's, on the same weights
(the JAX scope carried over by ``interop.load_reference_state``).

Tolerances: logits within 1e-4 and caches within 1e-5 (fp32 math in
another summation order, through 2 layers and a 53-way head); greedy
tokens identical.

A bfloat16 KV cache (``cache_dtype="bfloat16"`` in both packages): the
first layer's cache within one bf16 ulp (K/V rounded to bf16 from
float32 projections that differ in their last bits); the deeper layers'
caches and the decode logits at one bfloat16 rounding (rtol 1e-2 plus
4e-3 of the largest magnitude), because the decode kernel's chunked walk
rounds p = exp(s - m) to bf16 against other maxima than the JAX
kernel's single walk, which moves each layer's attention output at the
bf16 level (tests/test_torch_flash_attention.py); prefill logits within
1e-4 (the prompt's attention reads float32 K/V); greedy tokens
identical."""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import layers as jlayers
from paddle_tpu import unique_name as jnames
from paddle_tpu.models.transformer import (
    build_transformer_decode as jbuild_decode, transformer_lm as jlm)
from paddle_tpu.serving.decode import (DecodeEngine as JEngine,
                                       DecodeLoop as JLoop)
from paddle_tpu_torch import interop
from paddle_tpu_torch import layers as tlayers
from paddle_tpu_torch import unique_name as tnames
from paddle_tpu_torch.models.transformer import (
    build_transformer_decode as tbuild_decode, transformer_lm as tlm)
from paddle_tpu_torch.serving import (BatchTooLarge, Closed, DecodeEngine,
                                      DecodeLoop, Overloaded, SlotAllocator)
from paddle_tpu_torch.serving.decode import active_loops

# Under pytest-xdist each worker takes its share of the cores for
# torch's intra-op threads: six workers at torch's default thread count
# oversubscribe the cores, and a test of seconds then takes minutes.
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

VOCAB, D_MODEL, N_LAYERS, N_HEADS, MAX_LEN = 53, 32, 2, 4, 32
SIZE = dict(d_model=D_MODEL, num_layers=N_LAYERS, num_heads=N_HEADS,
            max_len=MAX_LEN)
CPU = tfluid.CPUPlace()


def _one_shot(fluid, layers, names, lm):
    with names.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            tokens = layers.data("tokens", [-1], dtype="int64")
            logits = lm(tokens, VOCAB, **SIZE)
    return prog, startup, logits


@pytest.fixture(scope="module")
def models():
    """JAX weights (its startup program), carried into the port; both
    packages' one-shot programs and warmed decode engines."""
    jprog, jstart, jlogits = _one_shot(jfluid, jlayers, jnames, jlm)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor()
    jexe.run(jstart, scope=jscope)
    arrays = {v.name: np.asarray(jscope.find_var(v.name))
              for v in jprog.list_vars() if v.persistable}

    tprog, tstart, tlogits = _one_shot(tfluid, tlayers, tnames, tlm)
    tscope = tfluid.Scope()
    interop.load_reference_state(arrays, tscope, CPU, tprog)
    texe = tfluid.Executor(CPU)

    jpre, jdec, jmeta = jbuild_decode(vocab_size=VOCAB, **SIZE)
    jengine = JEngine(jpre, jdec, jmeta, num_slots=2, prompt_buckets=(8, 16),
                      scope=jscope, service="torch-parity-jax")
    jengine.warmup()
    tpre, tdec, tmeta = tbuild_decode(vocab_size=VOCAB, **SIZE)
    tengine = DecodeEngine(tpre, tdec, tmeta, num_slots=2,
                           prompt_buckets=(8, 16), scope=tscope, place=CPU)
    tengine.warmup()

    def jax_one_shot(seq):
        out, = jexe.run(jprog, feed={"tokens": np.asarray(
            seq, np.int64).reshape(1, -1)}, fetch_list=[jlogits],
            scope=jscope)
        return np.asarray(out)[0]

    def port_one_shot(seq):
        out, = texe.run(tprog, feed={"tokens": np.asarray(
            seq, np.int64).reshape(1, -1)}, fetch_list=[tlogits],
            scope=tscope)
        return out[0]

    yield dict(arrays=arrays, jengine=jengine, tengine=tengine,
               jax_one_shot=jax_one_shot, port_one_shot=port_one_shot,
               tprog=tprog, tscope=tscope)
    assert active_loops() == [], "a test left a port DecodeLoop open"


def _greedy(loop, prompt, n, **kw):
    return loop.submit(prompt, max_new_tokens=n, **kw).result(timeout=120)


class TestInterop:
    def test_scope_holds_the_reference_arrays(self, models):
        for n, a in models["arrays"].items():
            t = models["tscope"].find_var(n)
            assert t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), a)

    def test_mismatches_raise(self, models):
        arrays, prog = models["arrays"], models["tprog"]
        scope = tfluid.Scope()
        extra = dict(arrays, bogus=np.zeros(3, np.float32))
        with pytest.raises(ValueError, match="unknown"):
            interop.load_reference_state(extra, scope, CPU, prog)
        short = dict(arrays)
        short.pop("fc_0.w_0")
        with pytest.raises(ValueError, match="missing"):
            interop.load_reference_state(short, scope, CPU, prog)
        bad = dict(arrays, **{"fc_0.w_0": arrays["fc_0.w_0"][:1]})
        with pytest.raises(ValueError, match="shape"):
            interop.load_reference_state(bad, scope, CPU, prog)
        assert scope.vars == {}


class TestForwardParity:
    @pytest.mark.parametrize("n", [2, 7, 20])
    def test_one_shot_logits_match(self, models, n):
        seq = np.random.RandomState(n).randint(0, VOCAB, n)
        np.testing.assert_allclose(models["port_one_shot"](seq),
                                   models["jax_one_shot"](seq),
                                   rtol=1e-4, atol=1e-4)

    def test_prefill_logits_and_caches_match(self, models):
        je, te = models["jengine"], models["tengine"]
        jc, tc = je.new_cache(), te.new_cache()
        prompt = np.random.RandomState(3).randint(1, VOCAB, 11)
        jl = je.prefill(prompt, 1, jc)
        tl = te.prefill(prompt, 1, tc)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        assert tc.pos.tolist() == jc.pos.tolist() == [0, 11]
        for n in te.meta.cache_names:
            np.testing.assert_allclose(tc.buffers[n].numpy(),
                                       np.asarray(jc.buffers[n]),
                                       rtol=1e-5, atol=1e-5)

    def test_decode_step_logits_and_caches_match(self, models):
        je, te = models["jengine"], models["tengine"]
        jc, tc = je.new_cache(), te.new_cache()
        rng = np.random.RandomState(5)
        for slot, n in ((0, 4), (1, 9)):
            p = rng.randint(1, VOCAB, n)
            je.prefill(p, slot, jc)
            te.prefill(p, slot, tc)
        toks = np.asarray([7, 11], np.int64)
        jl = je.decode_step(toks, jc)
        tl = te.decode_step(toks, tc)
        assert tl.shape == np.asarray(jl).shape
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        for n in te.meta.cache_names:
            np.testing.assert_allclose(tc.buffers[n].numpy(),
                                       np.asarray(jc.buffers[n]),
                                       rtol=1e-5, atol=1e-5)


class TestDecodeParity:
    def test_greedy_tokens_identical_to_jax_decode_loop(self, models):
        rng = np.random.RandomState(7)
        cases = [(rng.randint(1, VOCAB, plen), n)
                 for plen, n in ((2, 8), (7, 10), (13, 6))]
        with JLoop(models["jengine"], name="torch-parity-jax") as jloop:
            want = [_greedy(jloop, p, n) for p, n in cases]
        with DecodeLoop(models["tengine"], name="parity") as loop:
            got = [_greedy(loop, p, n) for p, n in cases]
        assert got == want
        for (p, n), (toks, reason) in zip(cases, got):
            assert reason == "length" and len(toks) == n

    def test_greedy_equals_port_one_shot_argmax(self, models):
        rng = np.random.RandomState(11)
        with DecodeLoop(models["tengine"], name="one-shot") as loop:
            for plen, n in ((3, 9), (8, 5), (15, 7)):
                prompt = rng.randint(1, VOCAB, plen)
                toks, _ = _greedy(loop, prompt, n)
                logits = models["port_one_shot"](
                    np.concatenate([prompt, toks[:-1]]))
                assert toks == np.argmax(logits[plen - 1:], -1).tolist()

    def test_concurrent_slots_stay_token_identical(self, models):
        p1, p2 = np.arange(1, 6), np.arange(10, 13)
        with DecodeLoop(models["tengine"], name="solo") as loop:
            solo, _ = _greedy(loop, p1, 8)
        with DecodeLoop(models["tengine"], name="pair") as loop:
            g1 = loop.submit(p1, max_new_tokens=8)
            g2 = loop.submit(p2, max_new_tokens=8)
            assert g1.result(timeout=120)[0] == solo
            g2.result(timeout=120)

    def test_continuous_and_static_batching_agree(self, models):
        engine = models["tengine"]
        rng = np.random.RandomState(0)
        work = [(rng.randint(1, VOCAB, rng.randint(3, 15)),
                 12 if i % 2 == 0 else 3) for i in range(5)]
        with DecodeLoop(engine, name="continuous") as loop:
            gens = [loop.submit(p, max_new_tokens=m) for p, m in work]
            cont = [g.result(timeout=120)[0] for g in gens]
            # short requests ride along: far fewer steps than the sum
            assert loop.steps_dispatched() < sum(m for _, m in work) - 5
        cache = engine.new_cache()
        static = []
        for base in range(0, len(work), engine.num_slots):
            group = work[base:base + engine.num_slots]
            live, last = {}, np.zeros(engine.num_slots, np.int64)
            for i, (p, _) in enumerate(group):
                live[i] = [int(np.argmax(engine.prefill(p, i, cache)))]
                last[i] = live[i][0]
            while any(len(live[i]) < group[i][1] for i in live):
                logits = engine.decode_step(last, cache)
                for i in live:
                    cache.pos[i] += 1
                    if len(live[i]) < group[i][1]:
                        live[i].append(int(np.argmax(logits[i])))
                        last[i] = live[i][-1]
            static.extend(live[i] for i in range(len(group)))
            cache.pos[:] = 0
        assert cont == static


@pytest.fixture(scope="module")
def bf16_engines(models):
    """Both packages' decode engines over bfloat16 caches, from the same
    weights as ``models``."""
    jpre, jdec, jmeta = jbuild_decode(vocab_size=VOCAB, **SIZE)
    jengine = JEngine(jpre, jdec, jmeta, num_slots=2, prompt_buckets=(8, 16),
                      scope=models["jengine"].scope,
                      service="torch-parity-jax-bf16", cache_dtype="bfloat16")
    jengine.warmup()
    tpre, tdec, tmeta = tbuild_decode(vocab_size=VOCAB, **SIZE)
    tengine = DecodeEngine(tpre, tdec, tmeta, num_slots=2,
                           prompt_buckets=(8, 16), scope=models["tscope"],
                           place=CPU, cache_dtype="bfloat16")
    tengine.warmup()
    return jengine, tengine


def _bf16_bound(got, want):
    err = np.abs(got - want)
    return (err <= 1e-2 * np.abs(want) + 4e-3 * np.abs(want).max()).all()


def _within_one_ulp(got, want):
    """|got - want| within one bf16 ulp of the larger magnitude."""
    g, w = torch.from_numpy(got), torch.from_numpy(want)
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    return bool(((g - w).abs() <= torch.ldexp(torch.ones_like(g), e - 8))
                .all())


class TestBf16Cache:
    def test_logits_and_caches_match_jax(self, bf16_engines):
        je, te = bf16_engines
        jc, tc = je.new_cache(), te.new_cache()
        rng = np.random.RandomState(5)
        for slot, n in ((0, 4), (1, 9)):
            p = rng.randint(1, VOCAB, n)
            np.testing.assert_allclose(te.prefill(p, slot, tc),
                                       je.prefill(p, slot, jc),
                                       rtol=1e-4, atol=1e-4)
        toks = np.asarray([7, 11], np.int64)
        for _ in range(4):
            jl = np.asarray(je.decode_step(toks, jc))
            tl = te.decode_step(toks, tc)
            assert tl.dtype == np.float32 and tl.shape == jl.shape
            assert _bf16_bound(tl, jl), float(np.abs(tl - jl).max())
            jc.pos += 1
            tc.pos += 1
            toks = np.argmax(jl[:, 0], -1).astype(np.int64)
        for n in te.meta.cache_names:
            got = tc.buffers[n].float().numpy()
            want = np.asarray(jc.buffers[n]).astype(np.float32)
            assert tc.buffers[n].dtype == torch.bfloat16
            if n.startswith("kv_l0_"):
                assert _within_one_ulp(got, want), n
            else:
                assert _bf16_bound(got, want), n

    def test_greedy_tokens_identical_to_jax(self, bf16_engines):
        je, te = bf16_engines
        rng = np.random.RandomState(7)
        cases = [(rng.randint(1, VOCAB, plen), n)
                 for plen, n in ((2, 8), (7, 10), (13, 6))]
        with JLoop(je, name="torch-parity-jax-bf16") as jloop:
            want = [_greedy(jloop, p, n) for p, n in cases]
        with DecodeLoop(te, name="parity-bf16") as loop:
            got = [_greedy(loop, p, n) for p, n in cases]
        assert got == want

    def test_cache_bytes_keys_and_dtype(self, models, bf16_engines):
        je, te = bf16_engines
        assert te.ready and te.compile_count() == 3 == je.compile_count()
        cache = te.new_cache()
        assert cache.dtype == torch.bfloat16
        assert all(b.dtype == torch.bfloat16 for b in cache.buffers.values())
        assert 2 * cache.nbytes() == models["tengine"].new_cache().nbytes()
        assert cache.nbytes() == je.new_cache().nbytes()
        assert all(k[-1] == ("kv", "bfloat16") for k in te._warm)
        assert all(k[-1] == ("kv", "float32")
                   for k in models["tengine"]._warm)
        with pytest.raises(ValueError, match="cache_dtype"):
            te.decode_step(np.zeros(2, np.int64),
                           models["tengine"].new_cache())


class TestServingContract:
    def test_warmup_counts_every_bucket_and_the_step(self, models):
        engine = models["tengine"]
        assert engine.ready and engine.compile_count() == 3
        assert engine.bucket_for(1) == 8 and engine.bucket_for(9) == 16

    def test_swap_state_copies_in_place_and_returns_copies(self, models):
        """The scope keeps its tensors (on the card the engine's graphs
        read them): the new values land in them, the old ones come back
        as copies, and swapping those back restores the logits."""
        engine, scope = models["tengine"], models["tscope"]
        names = engine._state_names
        held = {n: scope.find_var(n) for n in names}
        before = {n: t.clone() for n, t in held.items()}
        prompt = np.arange(1, 6)
        ref = engine.prefill(prompt, 0, engine.new_cache())
        old = engine.swap_state({n: t * 0.5 for n, t in before.items()})
        try:
            assert all(scope.find_var(n) is held[n] for n in names)
            assert all(torch.equal(held[n], before[n] * 0.5) for n in names)
            assert all(torch.equal(old[n], before[n]) for n in names)
            assert not np.array_equal(
                engine.prefill(prompt, 0, engine.new_cache()), ref)
        finally:
            engine.swap_state(old)
        assert all(torch.equal(held[n], before[n]) for n in names)
        np.testing.assert_array_equal(
            engine.prefill(prompt, 0, engine.new_cache()), ref)

    def test_batch_too_large_past_the_ladder(self, models):
        engine = models["tengine"]
        with pytest.raises(BatchTooLarge):
            engine.bucket_for(17)
        with DecodeLoop(engine, name="too-large") as loop:
            with pytest.raises(BatchTooLarge):
                loop.submit(np.ones(17, np.int64))
            with pytest.raises(ValueError):
                loop.submit([])

    def test_eos_and_length_termination(self, models):
        engine = models["tengine"]
        prompt = [4, 8, 15]
        with DecodeLoop(engine, name="eos") as loop:
            free, reason = _greedy(loop, prompt, 6)
            assert reason == "length" and len(free) == 6
            eos = free[2]
            toks, reason = _greedy(loop, prompt, 6, eos_id=eos)
            assert reason == "eos" and toks == free[:free.index(eos) + 1]
            # max_new_tokens clamps to the cache room the prompt leaves
            toks, reason = _greedy(loop, np.ones(16, np.int64), 100)
            assert reason == "length" and len(toks) == MAX_LEN - 16

    def test_cancel_frees_the_slot(self, models):
        with DecodeLoop(models["tengine"], name="cancel") as loop:
            g = loop.submit([1, 2, 3], max_new_tokens=25)
            g.cancel()
            toks, reason = g.result(timeout=120)
            assert reason == "cancelled" and len(toks) < 25
            assert _greedy(loop, [1, 2, 3], 2)[1] == "length"
            assert loop.live_count() == 0

    def test_overloaded_and_closed(self, models):
        loop = DecodeLoop(models["tengine"], max_queue=1, name="shed")
        try:
            gens = []
            with pytest.raises(Overloaded):
                for _ in range(10):
                    gens.append(loop.submit([1, 2], max_new_tokens=20))
        finally:
            assert loop.close(drain=False, timeout=60)
        with pytest.raises(Closed):
            loop.submit([1, 2])
        for g in gens:
            try:
                g.result(timeout=60)
            except Closed:
                pass

    def test_slot_allocator(self):
        a = SlotAllocator(2)
        assert sorted([a.claim(), a.claim()]) == [0, 1]
        assert a.claim() is None and a.occupancy() == 1.0
        a.release(0)
        with pytest.raises(ValueError):
            a.release(0)
        assert a.claim() == 0

    def test_engine_refuses_state_on_another_device(self, models):
        import torch

        scope = tfluid.Scope()
        for n in models["arrays"]:
            scope.set_var(n, torch.empty(0, device="meta"))
        pre, dec, meta = tbuild_decode(vocab_size=VOCAB, **SIZE)
        with pytest.raises(ValueError, match="not on the engine's device"):
            DecodeEngine(pre, dec, meta, num_slots=1, prompt_buckets=(8,),
                         scope=scope, place=CPU)
