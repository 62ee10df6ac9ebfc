"""The port's host services against the JAX package's, on the CPU:
membership (``distributed/membership.py``), the task master
(``master.py``) and the parameter server (``pserver.py``).

* **Cross-talk.** Every service speaks the same line-JSON RPC: each case
  runs with a server of one package and clients of the other, both ways
  (and the port with itself), and gets the same answers.
* **Membership**: the epoch and lifecycle cases of
  tests/test_elastic_reshard.py:482-700 and
  tests/test_concurrency_membership.py:82-126; a snapshot one package's
  server wrote is recovered by the other's.
* **Master**: the cases of tests/test_distributed.py:26-155 and
  tests/test_elasticity.py (a trainer process killed holding its lease;
  a replacement resumes from its checkpoint and every task finishes
  once); one package's master recovers the other's snapshot.
* **Parameter server**: a push whose reply is lost is retried and
  applied exactly once (``pserver.send_grad.recv``), both ways; two
  trainers' gradients sum at the sync barrier; the port's
  ``RemoteTrainer`` matches the JAX package's at rtol 1e-5.
* ``python -m paddle_tpu_torch serve --place cpu --membership`` registers
  the replica after warmup and SIGTERM deregisters it.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.distributed.master as jmaster
import paddle_tpu.distributed.membership as jmember
import paddle_tpu.distributed.pserver as jps
import paddle_tpu_torch.distributed.master as tmaster
import paddle_tpu_torch.distributed.membership as tmember
import paddle_tpu_torch.distributed.pserver as tps
from paddle_tpu import fault as jfault
from paddle_tpu_torch import fault as tfault

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, os.cpu_count() // int(_WORKERS)))

# (server package, client package)
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]
MEMBER = {"jax": jmember, "port": tmember}
MASTER = {"jax": jmaster, "port": tmaster}
PSERVER = {"jax": jps, "port": tps}
FAULT = {"jax": jfault, "port": tfault}


@pytest.fixture(autouse=True)
def _clean():
    for f in FAULT.values():
        f.clear()
    yield
    for f in FAULT.values():
        f.clear()


def _beats():
    return [t for t in threading.enumerate()
            if t.name.startswith("membership-beat-")]


# ---- membership ----

@pytest.mark.parametrize("srv_pkg,cl_pkg", PAIRS)
def test_membership_cross_talk(srv_pkg, cl_pkg):
    """register / discover / epoch / watch_world / elect / resign /
    deregister and an EpochWatcher, one package's client against the
    other's server: the same answers."""
    S, C = MEMBER[srv_pkg], MEMBER[cl_pkg]
    srv = S.MembershipServer(default_ttl=5.0, sweep_interval=0.1).start()
    try:
        c = C.MembershipClient(srv.address)
        e0 = c.epoch()
        assert c.register("trainer", "a", "a:1", heartbeat=False) == {
            "ttl": 5.0, "epoch": e0 + 1}
        c.register("trainer", "b", "b:2", ttl=3.0, heartbeat=False)
        assert c.discover("trainer") == [["a", "a:1"], ["b", "b:2"]]
        assert c.watch_world("trainer", wait=0.0) == (
            e0 + 2, (["a", "a:1"], ["b", "b:2"]))
        w = C.EpochWatcher(srv.address, kind="trainer", wait=1.0)
        assert w.snapshot()[0] == e0 + 2
        r1 = c.elect("save_model", "t0")
        r2 = c.elect("save_model", "t1")
        assert r1 == {"leader": "t0", "is_leader": True}
        assert r2 == {"leader": "t0", "is_leader": False}
        assert c.resign("save_model", "t0") == {"resigned": True}
        assert c.elect("save_model", "t1")["is_leader"]
        c.deregister("trainer", "b")
        deadline = time.time() + 5
        while w.snapshot()[0] != e0 + 3 and time.time() < deadline:
            time.sleep(0.02)
        assert w.snapshot() == (e0 + 3, (["a", "a:1"],))
        w.stop()
        c.close()
    finally:
        srv.shutdown()


def test_epoch_bumps_only_on_set_changes():
    srv = tmember.MembershipServer(default_ttl=5.0,
                                   sweep_interval=0.1).start()
    try:
        c = tmember.MembershipClient(srv.address)
        e0 = c.epoch()
        c.register("trainer", "a", "a:0", heartbeat=False)
        assert c.epoch() == e0 + 1
        c.register("trainer", "a", "a:0", heartbeat=False)
        assert c.epoch() == e0 + 1
        c._call("heartbeat", kind="trainer", name="a")
        assert c.epoch() == e0 + 1
        c.deregister("trainer", "a")
        assert c.epoch() == e0 + 2
        c.deregister("trainer", "a")
        assert c.epoch() == e0 + 2
        c.close()
    finally:
        srv.shutdown()


def test_sweep_expiry_bumps_once_per_batch_and_long_poll():
    srv = tmember.MembershipServer(default_ttl=1.0,
                                   sweep_interval=0.5).start()
    try:
        c = tmember.MembershipClient(srv.address)
        c.register("trainer", "a", "a:0", heartbeat=False)
        c.register("trainer", "b", "b:0", heartbeat=False)
        e = c.epoch()
        assert c.watch_epoch(known=e, wait=10.0) == e + 1
        assert c.discover("trainer") == []
        e0 = c.epoch()
        t = threading.Timer(0.3, lambda: tmember.MembershipClient(
            srv.address).register("trainer", "late", "l:0",
                                  heartbeat=False))
        t.start()
        t0 = time.monotonic()
        assert c.watch_epoch(known=e0, wait=10.0) == e0 + 1
        assert time.monotonic() - t0 < 5.0
        t.join()
        c.close()
    finally:
        srv.shutdown()


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_epoch_survives_snapshot_recovery_across_packages(tmp_path, first,
                                                          second):
    """One package's server writes the snapshot, the other's recovers
    it: the epoch never regresses."""
    snap = str(tmp_path / "membership.json")
    srv = MEMBER[first].MembershipServer(default_ttl=5.0,
                                         sweep_interval=0.05,
                                         snapshot_path=snap).start()
    c = MEMBER[first].MembershipClient(srv.address)
    c.register("trainer", "a", "a:0", heartbeat=False)
    c.deregister("trainer", "a")
    e = c.epoch()
    assert e >= 2
    c.close()
    srv.shutdown()
    srv2 = MEMBER[second].MembershipServer(default_ttl=5.0,
                                           snapshot_path=snap).start()
    try:
        c2 = MEMBER[second].MembershipClient(srv2.address)
        assert c2.epoch() >= e
        c2.close()
    finally:
        srv2.shutdown()


def test_register_discover_ttl_expiry_and_election():
    """tests/test_concurrency_membership.py:82-126."""
    srv = tmember.MembershipServer(default_ttl=0.6,
                                   sweep_interval=0.1).start()
    try:
        c1 = tmember.MembershipClient(srv.address)
        c2 = tmember.MembershipClient(srv.address)
        c1.register("pserver", "ps0", "10.0.0.1:7164", heartbeat=True,
                    ttl=0.6)
        c2.register("pserver", "ps1", "10.0.0.2:7164", heartbeat=False,
                    ttl=0.6)
        assert dict(c1.discover("pserver")) == {
            "ps0": "10.0.0.1:7164", "ps1": "10.0.0.2:7164"}
        time.sleep(1.2)
        found = dict(c1.discover("pserver"))
        assert "ps0" in found and "ps1" not in found
        a, b = c1, c2
        assert a.elect("save_model", "trainer0")["is_leader"]
        r2 = b.elect("save_model", "trainer1")
        assert not r2["is_leader"] and r2["leader"] == "trainer0"
        a.resign("save_model", "trainer0")
        assert b.elect("save_model", "trainer1")["is_leader"]
        c1.close()
        c2.close()
    finally:
        srv.shutdown()


class TestClientLifecycle:
    """tests/test_elastic_reshard.py's TestClientLifecycle on the port:
    no zombie beat keeps a dead owner's name alive."""

    def _srv(self, ttl=0.4, sweep=0.05):
        return tmember.MembershipServer(default_ttl=ttl,
                                        sweep_interval=sweep).start()

    def test_deregister_stops_heartbeat_promptly(self):
        srv = self._srv()
        try:
            c = tmember.MembershipClient(srv.address,
                                         heartbeat_interval=0.05)
            c.register("trainer", "a", "a:0", ttl=0.4)
            assert _beats()
            c.deregister("trainer", "a")
            assert not _beats()
            assert c.discover("trainer") == []
            c.close()
        finally:
            srv.shutdown()

    def test_beat_race_cannot_resurrect_or_keep_alive(self):
        srv = self._srv(ttl=0.3)
        try:
            c = tmember.MembershipClient(srv.address,
                                         heartbeat_interval=0.05)
            c.register("trainer", "a", "a:0", ttl=0.4, heartbeat=False)
            c.deregister("trainer", "a")
            e = c.epoch()
            assert c._call("heartbeat", kind="trainer", name="a",
                           ttl=5.0) == {"alive": False}
            assert c.discover("trainer") == [] and c.epoch() == e
            b = tmember.MembershipClient(srv.address,
                                         heartbeat_interval=0.05)
            c.register("trainer", "shared", "a:0", ttl=0.3)
            c.deregister("trainer", "shared")
            b.register("trainer", "shared", "b:0", ttl=0.3,
                       heartbeat=False)
            deadline = time.time() + 5.0
            while b.discover("trainer") and time.time() < deadline:
                time.sleep(0.05)
            assert b.discover("trainer") == []
            c.close()
            b.close()
        finally:
            srv.shutdown()

    def test_close_reregister_and_server_side_deregister(self):
        srv = self._srv(ttl=1.0, sweep=0.1)
        try:
            c = tmember.MembershipClient(srv.address,
                                         heartbeat_interval=0.05)
            c.register("trainer", "a", "a:0", ttl=1.0)
            c.register("trainer", "b", "b:0", ttl=1.0)
            assert len(_beats()) == 2
            c.register("trainer", "b", "b:1", ttl=1.0, heartbeat=False)
            assert len(_beats()) == 1
            admin = tmember.MembershipClient(srv.address)
            admin.deregister("trainer", "a")
            deadline = time.time() + 5.0
            while _beats() and time.time() < deadline:
                time.sleep(0.05)
            assert not _beats()
            c.close()
            with pytest.raises(RuntimeError, match="closed"):
                c.register("trainer", "x", "x:0", ttl=1.0)
            assert not _beats()
            admin.close()
        finally:
            srv.shutdown()

    def test_shared_watchers_refcounted(self):
        srv = self._srv(ttl=5.0, sweep=0.1)
        try:
            w1 = tmember.EpochWatcher.shared(srv.address, wait=0.5)
            w2 = tmember.EpochWatcher.shared(
                "%s:%d" % tuple(srv.address), wait=0.5)
            assert w1 is w2
            key = (srv.address[0], srv.address[1], "trainer")
            assert tmember.shared_watchers() == {key: 2}
            w1.stop()
            assert tmember.shared_watchers() == {key: 1}
            w2.stop()
            assert tmember.shared_watchers() == {}
        finally:
            srv.shutdown()


# ---- master ----

def _master(pkg, **kw):
    kw.setdefault("watchdog_interval", 0.02)
    return MASTER[pkg].MasterServer(("127.0.0.1", 0), **kw).start()


@pytest.mark.parametrize("srv_pkg,cl_pkg", PAIRS)
def test_master_dispatch_lease_retire_and_election(srv_pkg, cl_pkg):
    """tests/test_distributed.py:26-113 through one package's client
    against the other's master."""
    C = MASTER[cl_pkg]
    srv = _master(srv_pkg)
    try:
        with C.MasterClient(srv.address) as c:
            assert c.ping() == "pong"
            c.set_dataset(files=["a.rio", "b.rio", "c.rio"],
                          files_per_task=2)
            done = []
            for tid, payload in c.tasks(lease_timeout=5):
                done.append(json.loads(payload)["files"])
                assert c.task_finished(tid)
            assert sorted(map(tuple, done)) == [("a.rio", "b.rio"),
                                                ("c.rio",)]
            assert c.all_done()
            assert c.set_dataset(files=["x"])["already_set"]
            assert c.request_save_model("trainer-0", block_dur=0.2)
            assert not c.request_save_model("trainer-1", block_dur=0.2)
            assert c.request_save_model("trainer-0", block_dur=0.2)
            time.sleep(0.25)
            assert c.request_save_model("trainer-1", block_dur=0.2)
    finally:
        srv.shutdown()
    srv = _master(srv_pkg, failure_max=2)
    try:
        with C.MasterClient(srv.address) as dead, \
                C.MasterClient(srv.address) as c:
            c.set_dataset(task_payloads=["t0", "bad"])
            tid, payload = dead.get_task(timeout=0.05)  # the trainer dies
            assert payload == b"t0"
            seen_bad, t = 0, None
            deadline = time.time() + 5
            while time.time() < deadline:
                t = c.get_task(timeout=30)
                if t is None:
                    time.sleep(0.05)
                    continue
                if t[1] == b"bad":
                    seen_bad += 1
                    c.task_failed(t[0])
                    continue
                assert t[0] == tid      # re-dispatched after the lease
                c.task_finished(t[0])
                if seen_bad == 2:
                    break
            assert seen_bad == 2
            assert c.counts() == {"todo": 0, "pending": 0, "done": 1,
                                  "discarded": 1}
            assert c.all_done()
    finally:
        srv.shutdown()


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax"),
                                          ("port", "port")])
def test_master_snapshot_recovery_across_packages(tmp_path, first, second):
    snap = str(tmp_path / "master.snapshot")
    srv = _master(first, snapshot_path=snap)
    with MASTER[first].MasterClient(srv.address) as c:
        c.set_dataset(task_payloads=["p0", "p1", "p2"])
        tid, _ = c.get_task(timeout=300)
        c.task_finished(tid)
    srv.shutdown()
    srv2 = _master(second, snapshot_path=snap)
    try:
        with MASTER[second].MasterClient(srv2.address) as c:
            assert c.counts()["done"] == 1
            assert {c.get_task()[1], c.get_task()[1]} == {b"p1", b"p2"}
    finally:
        srv2.shutdown()


def test_master_concurrent_workers():
    srv = _master("port")
    try:
        with tmaster.MasterClient(srv.address) as c0:
            c0.set_dataset(task_payloads=["t%d" % i for i in range(40)])
        done, lock = [], threading.Lock()

        def worker(pkg):
            with MASTER[pkg].MasterClient(srv.address) as c:
                for tid, payload in c.tasks(lease_timeout=30):
                    with lock:
                        done.append(payload)
                    c.task_finished(tid)

        ts = [threading.Thread(target=worker, args=(p,))
              for p in ("port", "jax", "port", "jax")]
        [t.start() for t in ts]
        [t.join(timeout=30) for t in ts]
        assert sorted(done) == sorted(b"t%d" % i for i in range(40))
    finally:
        srv.shutdown()


_WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers, unique_name
from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
from paddle_tpu_torch.distributed.master import MasterClient

addr, ckpt_dir, log_path, crash_after = (
    sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]))
with unique_name.guard():
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = layers.data("x", [4])
        label = layers.data("label", [1], dtype="int64")
        pred = layers.fc(layers.fc(x, 8, act="tanh"), 3, act="softmax")
        cost = layers.mean(layers.cross_entropy(pred, label))
        fluid.optimizer.SGD(0.1).minimize(cost)
exe = fluid.Executor(fluid.CPUPlace())
scope = fluid.Scope()
exe.run(startup, scope=scope)
mgr = CheckpointManager(ckpt_dir, program=prog, scope=scope)
meta = mgr.restore()
step = meta["step"] if meta else 0
log = {"resumed_from": meta["step"] if meta else None, "finished": [],
       "acquired": []}

def flush():
    with open(log_path, "w") as f:
        json.dump(log, f)

flush()
host, port = addr.rsplit(":", 1)
client = MasterClient((host, int(port)))
done_tasks = 0
for tid, payload in client.tasks(poll_interval=0.3):
    log["acquired"].append(tid)
    flush()
    spec = json.loads(payload.decode())
    if crash_after >= 0 and done_tasks >= crash_after:
        os._exit(9)     # die holding the lease, mid-task
    rng = np.random.RandomState(spec["seed"])
    for _ in range(spec["steps"]):
        feed = {"x": rng.rand(4, 4).astype(np.float32),
                "label": rng.randint(0, 3, (4, 1)).astype(np.int64)}
        exe.run(prog, feed=feed, fetch_list=[cost.name], scope=scope)
        step += 1
    mgr.save(step, force=True)
    mgr.wait()
    client.task_finished(tid)
    done_tasks += 1
    log["finished"].append(tid)
    flush()
client.close()
print("WORKER_DONE", step)
"""


def _spawn(addr, ckpt, log, crash_after):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-c", _WORKER, addr, ckpt, log, str(crash_after)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env)


def test_trainer_crash_release_and_resume(tmp_path):
    """tests/test_elasticity.py on the port: trainer A finishes one task
    (with its checkpoint) and dies holding the second's lease; B resumes
    from A's checkpoint, finishes the re-leased task, and every task
    finishes exactly once; a live lease is never handed out twice. The
    lease (8 s) outlasts a task (3 CPU steps and a save) on a loaded
    host: a lease that expires under a live trainer hands its task out
    twice, by the lease's contract."""
    master = tmaster.MasterServer(lease_timeout=8.0, watchdog_interval=0.25,
                                  failure_max=5).start()
    addr = "%s:%d" % master.address
    try:
        client = tmaster.MasterClient(master.address)
        client.set_dataset(task_payloads=[
            json.dumps({"seed": i, "steps": 3}) for i in range(5)])
        ckpt = str(tmp_path / "ckpt")
        a = _spawn(addr, ckpt, str(tmp_path / "a.json"), 1)
        a.wait(timeout=120)
        assert a.returncode == 9, a.stdout.read()
        with open(tmp_path / "a.json") as f:
            la = json.load(f)
        assert len(la["finished"]) == 1 and len(la["acquired"]) == 2
        dead = la["acquired"][-1]
        b = _spawn(addr, ckpt, str(tmp_path / "b.json"), -1)
        out, _ = b.communicate(timeout=180)
        assert b.returncode == 0, out
        with open(tmp_path / "b.json") as f:
            lb = json.load(f)
        assert lb["resumed_from"] == 3 and dead in lb["finished"]
        assert len(sorted(la["finished"] + lb["finished"])) == 5
        assert client.counts() == {"todo": 0, "pending": 0, "done": 5,
                                   "discarded": 0}
        client.close()
    finally:
        master.shutdown()
    master = tmaster.MasterServer(lease_timeout=1.0,
                                  watchdog_interval=0.25).start()
    try:
        client = tmaster.MasterClient(master.address)
        client.set_dataset(task_payloads=["only"])
        t1 = client.get_task()
        assert client.get_task() is None
        time.sleep(1.6)
        t2 = client.get_task()
        assert t2 is not None and t2[0] == t1[0]
        client.task_finished(t2[0])
        assert client.all_done()
        client.close()
    finally:
        master.shutdown()


# ---- parameter server ----

@pytest.mark.parametrize("srv_pkg,cl_pkg", PAIRS)
def test_lost_reply_push_applies_exactly_once(srv_pkg, cl_pkg):
    """The reply to an applied push is lost (the client's
    ``pserver.send_grad.recv`` site): the retransmit carries the same
    sequence token and is acked as a duplicate, never applied twice."""
    ps = PSERVER[srv_pkg].ParameterServer(
        sync_mode=False, optimizer=PSERVER[srv_pkg].sgd_update(1.0)).start()
    cl = PSERVER[cl_pkg].PServerClient(ps.address, timeout=5.0,
                                       max_attempts=3)
    try:
        w0 = np.zeros(4, np.float32)
        g = np.arange(4, dtype=np.float32)
        cl.init_param("w", w0)
        with FAULT[cl_pkg].scope("pserver.send_grad.recv", drop=1.0,
                                 times=1):
            out = cl.send_grad("w", g)
        assert out.get("duplicate") is True
        assert cl.get_param("w").tobytes() == (w0 - g).tobytes()
        assert cl.param_names() == ["w"]
    finally:
        cl.close()
        ps.shutdown()


def test_sync_barrier_sums_two_trainers():
    ps = tps.ParameterServer(trainers=2,
                             optimizer=tps.sgd_update(0.5)).start()
    try:
        cls = [PSERVER[p].PServerClient(ps.address, timeout=10.0)
               for p in ("port", "jax")]
        cls[0].init_param("w", np.zeros(3, np.float32))
        out = [None, None]

        def push(i):
            out[i] = cls[i].send_grad("w", np.full(3, i + 1.0, np.float32),
                                      trainer_id=i)

        ts = [threading.Thread(target=push, args=(i,)) for i in range(2)]
        [t.start() for t in ts]
        [t.join(timeout=20) for t in ts]
        assert out == [{"applied": True}, {"applied": True}]
        np.testing.assert_array_equal(cls[0].get_param("w"),
                                      np.full(3, -1.5, np.float32))
        for c in cls:
            c.close()
    finally:
        ps.shutdown()


def _pserver_prog(fl):
    with fl.unique_name.guard():
        prog, startup = fl.Program(), fl.Program()
        with fl.program_guard(prog, startup):
            x = fl.layers.data("x", [4])
            label = fl.layers.data("label", [1], dtype="int64")
            h = fl.layers.fc(x, 8, act="tanh")
            pred = fl.layers.fc(h, 3, act="softmax")
            cost = fl.layers.mean(fl.layers.cross_entropy(pred, label))
            fl.optimizer.SGD(0.1).minimize(cost)
    return prog, startup, cost


def test_remote_trainer_matches_the_jax_package():
    """3 steps of the port's RemoteTrainer (an in-process port server,
    SGD) against the JAX package's RemoteTrainer on its own server, from
    the same weights: the same costs and parameters at rtol 1e-5; the
    port's also equals its local SGD Executor run."""
    import paddle_tpu as jf
    import paddle_tpu_torch as tf
    from paddle_tpu_torch import interop

    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(8, 4).astype(np.float32),
              "label": rng.randint(0, 3, (8, 1)).astype(np.int64)}
             for _ in range(3)]
    out = {}
    for name, fl, P in (("jax", jf, jps), ("port", tf, tps)):
        prog, startup, cost = _pserver_prog(fl)
        srv = P.ParameterServer(trainers=1,
                                optimizer=P.sgd_update(0.1)).start()
        try:
            scope = fl.Scope()
            if name == "jax":
                exe = jf.Executor()
                exe.run(startup, scope=scope)
                init = {v.name: np.asarray(scope.find_var(v.name))
                        for v in prog.list_vars() if v.persistable}
            else:
                exe = tf.Executor(tf.CPUPlace())
                interop.load_reference_state(init, scope, tf.CPUPlace(),
                                             [prog, startup])
            rt = P.RemoteTrainer(prog, ["%s:%d" % srv.address], exe=exe,
                                 scope=scope, init_params=True)
            costs = [float(np.asarray(rt.step(f, fetch_list=[cost.name])[0]))
                     for f in feeds]
            params = {p: np.asarray(scope.find_var(p)) if name == "jax"
                      else scope.find_var(p).numpy()
                      for p, _ in rt.params_grads}
            rt.close()
        finally:
            srv.shutdown()
        out[name] = (costs, params)
        if name == "port":
            local = tf.Scope()
            interop.load_reference_state(init, local, tf.CPUPlace(),
                                         [prog, startup])
            lexe = tf.Executor(tf.CPUPlace())
            lcosts = [float(lexe.run(prog, feed=f, fetch_list=[cost.name],
                                     scope=local)[0]) for f in feeds]
            np.testing.assert_allclose(costs, lcosts, rtol=1e-6)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-5)
    for p, v in out["jax"][1].items():
        np.testing.assert_allclose(out["port"][1][p], v, rtol=1e-5,
                                   atol=1e-6, err_msg=p)


# ---- serve --membership ----

def test_serve_membership_registers_and_sigterm_deregisters(tmp_path):
    import paddle_tpu_torch as fluid

    prog, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(prog, startup):
        img = fluid.layers.data("img", [8])
        pred = fluid.layers.fc(img, 3, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    model_dir = str(tmp_path / "model")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(model_dir, ["img"], [pred], exe,
                                      main_program=prog)
    srv = tmember.MembershipServer(default_ttl=5.0,
                                   sweep_interval=0.1).start()
    c = tmember.MembershipClient(srv.address)
    proc = None
    try:
        e0 = c.epoch()
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch", "serve",
             "--model-dir", model_dir, "--port", "0", "--max-batch", "2",
             "--place", "cpu", "--die-with-parent", "--membership",
             "%s:%d" % srv.address, "--name", "r0", "--ttl", "2",
             "--heartbeat-interval", "0.2"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO)
        line = ""
        deadline = time.time() + 120
        while time.time() < deadline and "listening" not in line:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "serve exited early"
        endpoint = line.split("listening on ")[1].split()[0]
        assert c.discover("replica") == [["r0", endpoint]]
        assert c.epoch() == e0 + 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert c.discover("replica") == []
        assert c.epoch() == e0 + 2
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        c.close()
        srv.shutdown()
