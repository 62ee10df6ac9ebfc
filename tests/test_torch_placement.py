"""``parallel/placement.py`` of the port against the JAX package's.

Every function reads the program alone, so the two packages are held
equal on the same programs in this process: ``legal_placements`` (the
candidates and their order), ``Placement``'s labels and axes,
``plan_stages`` (the cut points off the remat pass's live-activation
minima, proven gap-free by ``analysis.effects.check_stage_plan``, and
the refusal of an infeasible count), ``hbm_report``,
``estimate_wire_bytes`` and ``rank`` on the transformer rebuilt for
each placement (tests/test_placement.py's sizes).

One spawn of a gloo world of 4 (tests/torch_gloo_harness.py) builds the
meshes: ``Placement.mesh_for`` drops the unit axes as the JAX package's
does, and the transformer that a declared budget one byte below its
replicated footprint refuses at (1, 1, 1) fits under (2, 2, 1) and
trains there through ``ParallelExecutor(comm_config=CommConfig())``.
The pipeline half of tests/test_placement.py's acceptance: ``mesh_for``
builds the (1, 2, 2) placement's ('mp', 'pp') mesh as the JAX package's
does, and the transformer pp-staged under (2, 1, 2) (``pp_stages=2``)
trains there through ``ParallelExecutor``'s global view.
"""

import json
import os
import shutil
import sys
import tempfile

import numpy as np
import pytest

import test_torch_tensor_parallel as tt
import torch_gloo_harness as gh

TIMEOUT = 150
#: the placements whose meshes the world of 4 builds
MESH_FOR = ((2, 2, 1), (4, 1, 1), (1, 4, 1), (1, 1, 1))
#: the placements rebuilt and ranked
RANKED = ((8, 1, 1), (2, 4, 1), (4, 2, 1), (1, 8, 1))


def packages():
    import paddle_tpu as jfl
    import paddle_tpu_torch as tfl
    from paddle_tpu.parallel import placement as jpl
    from paddle_tpu_torch.parallel import placement as tpl

    return (jfl, jpl), (tfl, tpl)


def build(fl, p, num_layers=4):
    """The transformer rebuilt for placement ``p`` (mp splits when p.mp
    > 1), tests/test_placement.py's sizes."""
    mod = __import__(fl.__name__ + ".models.transformer",
                     fromlist=["build_transformer_lm"])
    with fl.unique_name.guard():
        prog, startup, _, (loss,) = mod.build_transformer_lm(
            vocab_size=tt.V, seq_len=tt.L, d_model=tt.DM,
            num_layers=num_layers, num_heads=tt.NH, lr=1e-2,
            mp=p.mp > 1, pp_stages=p.pp if p.pp > 1 else None)
    return prog, startup, loss


# ---- the port's side: one process a rank ----

def _worker(rank, world, d):
    gh.join(rank, world, d, TIMEOUT)
    import paddle_tpu_torch as fl
    from paddle_tpu_torch.parallel import CommConfig, ParallelExecutor
    from paddle_tpu_torch.parallel import placement as pl

    meshes = {}
    for key in MESH_FOR:
        m = pl.Placement(*key).mesh_for()
        meshes["%d,%d,%d" % key] = [list(m.axis_names),
                                    [m.shape[a] for a in m.axis_names],
                                    list(m.ranks)]
    pm = pl.Placement(1, 2, 2).mesh_for()
    pp_mesh = [list(pm.axis_names), [pm.shape[a] for a in pm.axis_names]]
    # the pipeline half: the transformer pp-staged under (2, 1, 2)
    p = pl.Placement(2, 1, 2)
    prog, startup, loss = build(fl, p, num_layers=tt.NL)
    startup.random_seed = 5
    scope = fl.Scope()
    fl.Executor(fl.CPUPlace()).run(startup, scope=scope)
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                          main_program=prog, mesh=p.mesh_for(),
                          zero_stage=0)
    pp_losses = [float(pe.run(feed=tt.tfm_feed(0), fetch_list=[loss.name],
                              scope=scope)[0]) for _ in range(2)]
    p = pl.Placement(2, 2, 1)
    prog, startup, loss = build(fl, p, num_layers=tt.NL)
    startup.random_seed = 5
    scope = fl.Scope()
    fl.Executor(fl.CPUPlace()).run(startup, scope=scope)
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                          main_program=prog, mesh=p.mesh_for(),
                          zero_stage=0, comm_config=CommConfig())
    losses = [float(pe.run(feed=tt.tfm_feed(s), fetch_list=[loss.name],
                           scope=scope)[0]) for s in range(2)]
    if rank == 0:
        with open(os.path.join(d, "out.json"), "w") as f:
            json.dump({"meshes": meshes, "pp_mesh": pp_mesh,
                       "pp_losses": pp_losses, "losses": losses}, f)
    gh.leave()


@pytest.fixture(scope="module")
def world4():
    d = tempfile.mkdtemp(prefix="ptp_pl_")
    try:
        gh.finish(gh.start(__file__, 4, d, TIMEOUT), d)
        with open(os.path.join(d, "out.json")) as f:
            return json.load(f)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def test_mesh_for_drops_unit_axes_as_the_jax_package(world4):
    (_, jpl), _ = packages()
    for key in MESH_FOR:
        jm = jpl.Placement(*key).mesh_for()
        names, shape, ranks = world4["meshes"]["%d,%d,%d" % key]
        assert tuple(names) == tuple(jm.axis_names), key
        assert shape == [jm.shape[a] for a in jm.axis_names], key
        assert ranks == list(range(int(np.prod(shape)))), key


def test_a_pipeline_mesh_waits_for_the_pipeline(world4):
    """The pipeline axis is ported: the (1, 2, 2) placement builds the
    JAX package's ('mp', 'pp') mesh, and the pp-staged transformer
    trains under (2, 1, 2)."""
    (_, jpl), _ = packages()
    jm = jpl.Placement(1, 2, 2).mesh_for()
    assert world4["pp_mesh"] == [list(jm.axis_names),
                                 [jm.shape[a] for a in jm.axis_names]]
    losses = world4["pp_losses"]
    assert np.isfinite(losses).all() and losses[1] < losses[0], losses


def test_the_overbudget_transformer_trains_under_dp2_mp2(world4):
    """tests/test_placement.py's TestHbmBudgetAcceptance, its dp x mp
    half: a budget one byte below the replicated footprint refuses
    (1, 1, 1) and admits (2, 2, 1), in both packages alike, and the
    port trains there. Its pp half:
    ``test_a_pipeline_mesh_waits_for_the_pipeline``."""
    (jfl, jpl), (tfl, tpl) = packages()
    reps = {}
    for fl, pl in ((jfl, jpl), (tfl, tpl)):
        single = pl.Placement(1, 1, 1)
        rep0 = pl.hbm_report(build(fl, single, tt.NL)[0], single)
        budget = rep0["per_device_bytes"] - 1
        p = pl.Placement(2, 2, 1)
        rep = pl.hbm_report(build(fl, p, tt.NL)[0], p, hbm_budget=budget)
        no = pl.hbm_report(build(fl, single, tt.NL)[0], single,
                           hbm_budget=budget)
        assert no["fits"] is False and rep["fits"] is True
        assert rep["per_device_bytes"] < rep0["per_device_bytes"]
        reps[fl.__name__] = (rep0, rep, no)
    assert reps["paddle_tpu"] == reps["paddle_tpu_torch"]
    losses = world4["losses"]
    assert np.isfinite(losses).all() and losses[1] < losses[0], losses


# ---- no spawn: the static search ----

@pytest.mark.parametrize("n,kw", [
    (8, dict(num_heads=4, num_layers=4, batch_size=16)),
    (8, dict(num_layers=4, batch_size=4)),
    (4, dict(num_heads=8, batch_size=8, num_micro=4)),
    (6, {}), (1, {})])
def test_legal_placements_equal_the_jax_packages(n, kw):
    (_, jpl), (_, tpl) = packages()
    want = [p.key for p in jpl.legal_placements(n, **kw)]
    assert [p.key for p in tpl.legal_placements(n, **kw)] == want


@pytest.mark.parametrize("key", [(1, 1, 1), (2, 2, 2), (4, 2, 1), (1, 8, 1),
                                 (1, 1, 4)])
def test_placements_read_as_jax(key):
    (_, jpl), (_, tpl) = packages()
    a, b = tpl.Placement(*key), jpl.Placement(*key)
    assert (a.label, a.axes(), a.describe(), a.world, repr(a)) == \
        (b.label, b.axes(), b.describe(), b.world, repr(b))


@pytest.mark.parametrize("pp", [2, 4])
def test_plan_stages_equal_the_jax_packages(pp):
    (jfl, jpl), (tfl, tpl) = packages()
    p = jpl.Placement()
    assert tpl.plan_stages(build(tfl, p)[0], pp) == \
        jpl.plan_stages(build(jfl, p)[0], pp)


@pytest.mark.parametrize("pp", [1, 1000])
def test_plan_stages_refuses_an_infeasible_count_as_jax(pp):
    (jfl, jpl), (tfl, tpl) = packages()
    p = jpl.Placement()
    msgs = []
    for fl, pl in ((jfl, jpl), (tfl, tpl)):
        with pytest.raises(ValueError, match="live-activation minima") as e:
            pl.plan_stages(build(fl, p)[0], pp)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("key", RANKED + ((2, 2, 1), (1, 1, 1)))
@pytest.mark.parametrize("batch", [1, 16])
def test_hbm_and_wire_bytes_equal_the_jax_packages(key, batch):
    (jfl, jpl), (tfl, tpl) = packages()
    jp, tp = jpl.Placement(*key), tpl.Placement(*key)
    jprog, tprog = build(jfl, jp)[0], build(tfl, tp)[0]
    assert tpl.estimate_wire_bytes(tprog, tp, batch=batch) == \
        jpl.estimate_wire_bytes(jprog, jp, batch=batch)
    assert tpl.hbm_report(tprog, tp, hbm_budget=1 << 20) == \
        jpl.hbm_report(jprog, jp, hbm_budget=1 << 20)


def test_rank_equals_the_jax_packages():
    (jfl, jpl), (tfl, tpl) = packages()

    def rows(fl, pl):
        out = pl.rank([pl.Placement(*k) for k in RANKED],
                      lambda p: build(fl, p)[0], batch=16)
        return [(r["placement"].key, r["wire"], r["hbm"]) for r in out]

    assert rows(tfl, tpl) == rows(jfl, jpl)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
