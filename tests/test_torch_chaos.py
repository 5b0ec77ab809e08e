"""The port's fault layer (``repro_torch.core.faults``) against the JAX
package's, on the CPU.

1. sim: tests/test_chaos.py's seeded cases (worker and scheduler kills
   across the steal x migration x coalesce matrix, the explicit
   scheduler kill, root death, the poison cap, replay backoff, snapshot
   commits) give the same fault summary, run report and labelled
   storage on both packages: the sim is deterministic, so the
   comparison is exact.
2. threads: worker kills and the heartbeat end with the serial
   oracle's storage, or fail by name.
3. Region snapshots with torch payloads through the port's
   ``CheckpointStore``: f32, bf16 and int tensors come back bit for bit
   with their dtype, a dict of tensors is skipped and counted.
4. procs: a worker killed while a read-modify-write body is in flight
   rolls the object back and replays it once.  The body announces
   itself in a file and waits for a second one, so the kill lands in
   the window by construction, not by a timer.
"""

import dataclasses
import os
import random
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jax_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import test_chaos as jax_chaos  # noqa: E402
from repro.analysis.invariants import check_invariants  # noqa: E402
from repro.core import faults as jax_faults  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.core import InOut, Out  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from test_backend_threads import build_wait_app, random_program  # noqa: E402
from test_core_shards import skewed_alloc_app  # noqa: E402

NAMES = ("In", "Out", "InOut", "Safe", "task")


def _on(core, fn):
    """``fn`` with ``core``'s annotations and ``@task`` (sim and threads
    run it in this process, so a rebound globals dict is enough)."""
    env = {**fn.__globals__, **{n: getattr(core, n) for n in NAMES}}
    return types.FunctionType(fn.__code__, env, fn.__name__, fn.__defaults__, fn.__closure__)


def _wait_app(core, seed):
    return _on(core, build_wait_app)(random_program(random.Random(seed)))


def _run(core, app, kw, faults_spec=None):
    """(report as a dict, labelled storage, runtime) of one sim run."""
    rt = core.Myrmics(**kw, **({} if faults_spec is None else {"faults": faults_spec}))
    rep = rt.run(app)
    return dataclasses.asdict(rep), rt.labelled_storage(), rt


def _plan(core, spec):
    """A dict spec as is, or a ``FaultPlan`` of ``core``'s faults module."""
    if isinstance(spec, dict) and "plan" in spec:
        mod = jax_faults if core is jax_core else faults
        return mod.FaultPlan(**spec["plan"])
    return spec


def _case_worker_kills(core, seed, steal, migrate, coalesce):
    app = _wait_app(core, seed)
    kw = dict(n_workers=4, sched_levels=[1, 2], steal=steal, migrate_threshold=migrate,
              coalesce=coalesce)
    base = _run(core, app, kw)[0]["total_cycles"]
    return app, kw, {"seed": seed, "n_kills": 2, "window": (0.1 * base, 0.8 * base)}


def _case_sched_kills(core, seed):
    app = _wait_app(core, seed)
    kw = dict(n_workers=8, sched_levels=[1, 4], steal=True)
    base = _run(core, app, kw)[0]["total_cycles"]
    return app, kw, {"seed": seed, "n_kills": 2, "kill_scheds": True,
                     "window": (0.1 * base, 0.8 * base)}


def _case_explicit_sched_kill(core):
    app = _on(core, skewed_alloc_app)()
    kw = dict(n_workers=8, sched_levels=[1, 2], migrate_threshold=6)
    base = _run(core, app, kw)[0]["total_cycles"]
    return app, kw, {"kills": [("s1.1", base * 0.6)]}


def _case_backoff(core, delay):
    return (_on(core, jax_chaos._long_task_app), dict(n_workers=2, sched_levels=[1]),
            {"kills": [("w0", 1e6)], "replay_delay": delay})


def _case_snapshots(core, tmp):
    return (_on(core, jax_chaos._chain_app), dict(n_workers=2, sched_levels=[1]),
            {"plan": {"kills": (("w0", 2.5e6),), "snapshot_dir": str(tmp / core.__name__)}})


SIM_CASES = (
    [(f"worker_kills-{seed}-{steal}-{migrate}-{coalesce}", _case_worker_kills,
      (seed, steal, migrate, coalesce))
     for steal, migrate, coalesce in [(True, None, True), (False, 4, False), (True, 4, True)]
     for seed in range(8)]
    + [(f"sched_kills-{seed}", _case_sched_kills, (seed,)) for seed in range(6)]
    + [("explicit_sched_kill", _case_explicit_sched_kill, ()),
       ("backoff-0", _case_backoff, (0.0,)), ("backoff-3e7", _case_backoff, (3e7,)),
       ("snapshots", _case_snapshots, ("tmp",))]
)


@pytest.mark.parametrize("case", SIM_CASES, ids=[c[0] for c in SIM_CASES])
def test_sim_chaos_identical_on_both_packages(case, tmp_path):
    _, build, args = case
    args = tuple(tmp_path if a == "tmp" else a for a in args)
    got, want = {}, {}
    for core, out in ((jax_core, want), (port_core, got)):
        app, kw, spec = build(core, *args)
        out["rep"], out["store"], out["rt"] = _run(core, app, kw, _plan(core, spec))
    assert got["store"] == want["store"]
    assert got["rep"] == want["rep"]          # fault summary, cycles, messages, DMA
    summary = got["rt"].fault_injector.counters()
    assert summary == want["rt"].fault_injector.counters()
    assert summary["workers_killed"] + summary["scheds_killed"] + summary["tasks_replayed"] > 0
    assert got["store"] == _oracle(app)
    check_invariants(got["rt"])


def _oracle(app):
    sr = port_core.SerialRuntime()
    sr.run(app)
    return sr.labelled_storage()


@pytest.mark.parametrize("name", ["root_death", "poison_cap"])
def test_sim_failures_fail_by_name_on_both_packages(name):
    msgs = []
    for core, mod in ((jax_core, jax_faults), (port_core, faults)):
        if name == "root_death":
            rt = core.Myrmics(n_workers=4, sched_levels=[1, 2], faults=True)
            with pytest.raises(mod.SchedulerDiedError, match="root") as err:
                rt.kill_scheduler("s0.0")
        else:
            rt = core.Myrmics(n_workers=2, sched_levels=[1],
                              faults={"kills": [("w0", 1e6)], "max_replays": 0})
            with pytest.raises(mod.PoisonTaskError, match="max_replays=0") as err:
                rt.run(_on(core, jax_chaos._long_task_app))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("seed", [0, 2, 5, 7])
def test_threads_worker_kills_match_the_serial_oracle(seed):
    app = _wait_app(port_core, seed)
    rt = port_core.Myrmics(n_workers=4, sched_levels=[1, 2], backend="threads",
                           faults={"kills": (("w1", 0.001), ("w3", 0.002))}, max_wall_s=60.0)
    rep = rt.run(app)
    assert rep.fault_summary()["workers_killed"] == 2
    assert rep.tasks_spawned == rep.tasks_done
    assert rt.labelled_storage() == _oracle(app)
    check_invariants(rt)


def test_threads_heartbeat_death_fails_fast():
    rt = port_core.Myrmics(n_workers=2, sched_levels=[1, 2], backend="threads", faults=True)
    with pytest.raises(faults.SchedulerDiedError, match="heartbeat"):
        rt._h_sched_dead("s1.0", "heartbeat")
    assert rt.fault_injector.detections.get("sched:heartbeat") == 1


def test_threads_heartbeat_quiet_on_healthy_run():
    def app(ctx, root):
        oids = ctx.balloc(64, root, 8, label="x")
        for i, o in enumerate(oids):
            ctx.spawn(lambda c, oo, v=i: c.write(oo, v * 3), [Out(o)])
        yield ctx.wait([InOut(root)])

    rt = port_core.Myrmics(n_workers=2, sched_levels=[1, 2], backend="threads",
                           faults={"heartbeat_s": 0.01})
    fs = rt.run(app).fault_summary()
    assert fs["workers_killed"] == 0 and fs["scheds_killed"] == 0 and not fs["detections"]
    assert rt.labelled_storage()["x[5]"] == 15


# ---------------------------------------------------------------------------
# region snapshots with torch payloads
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(0)
PAYLOADS = {
    "f32": torch.from_numpy(RNG.standard_normal((3, 4)).astype(np.float32)),
    "bf16": torch.from_numpy(RNG.standard_normal((5,)).astype(np.float32)).to(torch.bfloat16),
    "i64": torch.from_numpy(RNG.integers(-2**40, 2**40, (2, 3))),
    "f32_scalar": torch.tensor(1.5),
    "int": 7, "float": 2.25, "bool": True, "list": [1, 2, 3], "tuple": (4.0, 5.0),
    "nparray": RNG.standard_normal((2, 2)),
}


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_snapshot_round_trip_through_the_store(name, tmp_path):
    value = PAYLOADS[name]
    arr, tag = faults._encode(value)
    store = CheckpointStore(str(tmp_path))
    store.save(1, {"9": arr}, extra={"types": {"9": tag}})
    got = faults._decode(store.restore(1, like={"9": 0})["9"],
                         store.extra(1)["types"]["9"])
    assert type(got) is type(value)
    if isinstance(value, torch.Tensor):
        assert tag == "tensor" and got.dtype == value.dtype and got.device.type == "cpu"
        assert torch.equal(got, value)
    elif isinstance(value, np.ndarray):
        assert np.array_equal(got, value) and got.dtype == value.dtype
    else:
        assert got == value


def test_a_dict_of_tensors_is_skipped():
    assert faults._encode({"w": PAYLOADS["f32"]}) is None
    assert faults._encode("text") is None


def _tensor_app(ctx, root):
    oids = {name: ctx.alloc(64, root, label=name) for name in ("f32", "bf16", "i64")}
    tree = ctx.alloc(64, root, label="tree")
    for name, o in oids.items():
        ctx.spawn(lambda c, oo, n=name: c.write(oo, PAYLOADS[n].clone()), [Out(o)])
    ctx.spawn(lambda c, oo: c.write(oo, {"w": PAYLOADS["f32"]}), [Out(tree)])
    yield ctx.wait([InOut(root)])


def test_snapshots_commit_and_restore_tensors(tmp_path):
    """A run's tensor objects are committed (the dict is skipped and
    counted); a torn value rolls back to the committed bits and dtype
    when its executing victim dies."""
    rt = port_core.Myrmics(n_workers=2, sched_levels=[1],
                           faults=faults.FaultPlan(snapshot_dir=str(tmp_path)))
    fs = rt.run(_tensor_app).fault_summary()
    assert fs["snapshots_saved"] >= 3 and fs["snapshots_skipped"] >= 1
    snaps = rt.fault_injector.snapshots
    by_label = {rt.labels[nid]: nid for nid in snaps.by_nid if nid in rt.labels}
    assert {"f32", "bf16", "i64"} <= set(by_label)

    class _Arg:
        def __init__(self, nid):
            self.nid, self.mode, self.notransfer = nid, "w", False

    for name in ("f32", "bf16", "i64"):
        nid = by_label[name]
        rt.storage[nid] = torch.zeros(1)            # a torn write
        victim = types.SimpleNamespace(dep_args=[_Arg(nid)])
        snaps.on_worker_death("w0", [victim])
        got = rt.storage[nid]
        assert got.dtype == PAYLOADS[name].dtype and torch.equal(got, PAYLOADS[name])


# ---------------------------------------------------------------------------
# procs: the torn in-flight task, made deterministic
# ---------------------------------------------------------------------------


def _torn_app(gate: str):
    """tests/test_backend_procs.py's RMW chain.  The first RMW body that
    runs away from main's worker (whose death is unrecoverable: main is
    parked there) writes its worker id to ``<gate>/started`` and waits
    for ``<gate>/go``."""
    def app(ctx, root):
        home = ctx.worker_id
        oids = ctx.balloc(64, root, 6, label="r")
        for i, o in enumerate(oids):
            ctx.spawn(lambda c, oo, v=i: c.write(oo, v + 1), [Out(o)])
        for o in oids:
            def rmw(c, oo, gate=gate, home=home):
                import os
                import time
                started, go = os.path.join(gate, "started"), os.path.join(gate, "go")
                if c.worker_id != home and not os.path.exists(go):
                    with open(started + ".tmp", "w") as f:
                        f.write(c.worker_id)
                    os.replace(started + ".tmp", started)
                    while not os.path.exists(go):
                        time.sleep(0.01)
                c.write(oo, c.read(oo) * 2 + 1)
            ctx.spawn(rmw, [InOut(o)])
        yield ctx.wait([InOut(root)])
    return app


def test_procs_snapshot_restores_torn_inflight_task(tmp_path):
    gate = tmp_path / "gate"
    gate.mkdir()
    app = _torn_app(str(gate))
    want = _oracle(_torn_app(str(tmp_path / "no_gate")))
    rt = port_core.Myrmics(n_workers=2, sched_levels=[1], backend="procs", max_wall_s=120.0,
                           faults=faults.FaultPlan(snapshot_dir=str(tmp_path / "snaps")))
    killed = []

    def killer():
        deadline = time.time() + 90.0
        while time.time() < deadline and not (gate / "started").exists():
            time.sleep(0.01)
        if not (gate / "started").exists():
            (gate / "go").touch()
            return
        wid = (gate / "started").read_text()
        proc = rt.sub._channels[wid].proc
        rt.kill_worker(wid)
        # let the body go only once its process is gone: nothing it
        # could still write may reach the host
        proc.join(timeout=30)
        killed.append((wid, proc.is_alive()))
        (gate / "go").touch()

    thread = threading.Thread(target=killer, daemon=True)
    thread.start()
    rep = rt.run(app)
    thread.join(timeout=10)
    fs = rep.fault_summary()
    assert len(killed) == 1 and not killed[0][1], killed      # the worker died
    assert fs["workers_killed"] == 1 and killed[0][0] in rt.dead_workers
    assert fs["snapshots_saved"] > 0 and fs["snapshots_restored"] >= 1
    assert rt.labelled_storage() == want
    assert os.path.exists(gate / "go")
