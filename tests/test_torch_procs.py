"""The port's procs backend (``repro_torch.core.backend_procs``) on the
CPU: the program-level cases of tests/test_backend_procs.py (its seeded
random programs, its pipeline and tests/test_core_api.py's two front
ends) end with the same labelled storage as the JAX package's procs run
and as the port's serial oracle; torch tensors cross the wire bit for
bit; workers are spawned, and forced to fork (in a process of its own
that loads neither JAX nor torch's thread pools) they run too; a
written tensor that is not on the CPU is refused by name.

A procs worker rebuilds a shipped function against its module's
globals, so the apps run here are the JAX tests' code objects bound to
this module's globals, where ``In``/``Out``/``InOut``/``Safe``/``task``
are the port's.
"""

import os
import random
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jax_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import test_backend_threads as jax_threads_tests  # noqa: E402
import test_core_api as jax_api_tests  # noqa: E402
from repro_torch.core import In, InOut, Out, Safe, task  # noqa: E402,F401  (the apps' globals)
from repro_torch.core import backend_procs  # noqa: E402
from test_backend_threads import _descends, random_program  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]


def _here(fn):
    """``fn``'s code bound to this module's globals."""
    return types.FunctionType(fn.__code__, globals(), fn.__name__, fn.__defaults__)


def _here_task(tf):
    """A JAX test's module-level ``@task`` rebuilt on the port's ``task``,
    its annotations taken from the port."""
    fn = _here(tf.fn)
    fn.__annotations__ = {k: getattr(port_core, v._name)
                          for k, v in tf.fn.__annotations__.items()}
    return task(fn)


t_init = _here_task(jax_threads_tests.t_init)
t_bump = _here_task(jax_threads_tests.t_bump)
t_reduce = _here_task(jax_threads_tests.t_reduce)
pipeline_app = _here(jax_threads_tests.pipeline_app)
build_wait_app = _here(jax_threads_tests.build_wait_app)
APPS = {"pipeline": (pipeline_app, jax_threads_tests.pipeline_app),
        "legacy": (_here(jax_api_tests.legacy_app), jax_api_tests.legacy_app),
        "declarative": (_here(jax_api_tests.declarative_app), jax_api_tests.declarative_app)}


def _serial(app):
    sr = port_core.SerialRuntime()
    sr.run(app)
    return sr.labelled_storage()


def _procs(core, app, nw=2, levels=(1,), **kw):
    rt = core.Myrmics(n_workers=nw, sched_levels=list(levels), backend="procs",
                      max_wall_s=60.0, **kw)
    rep = rt.run(app)
    assert rep.backend == "procs" and rep.tasks_done == rep.tasks_spawned
    return rt, rep


@pytest.mark.parametrize("name,nw,levels", [("pipeline", 1, [1]), ("pipeline", 4, [1, 2]),
                                            ("legacy", 2, [1]), ("declarative", 4, [1])])
def test_apps_match_jax_procs_and_the_serial_oracle(name, nw, levels):
    port_app, jax_app = APPS[name]
    want = _serial(port_app)
    rt, _ = _procs(port_core, port_app, nw, levels)
    jax_rt, _ = _procs(jax_core, jax_app, nw, levels)
    assert rt.labelled_storage() == want == jax_rt.labelled_storage()


@pytest.mark.parametrize("seed,steal,migrate,coalesce", [(0, True, None, True),
                                                         (3, False, 1, False),
                                                         (9, True, None, True)])
def test_random_programs_match_jax_procs_and_the_serial_oracle(seed, steal, migrate, coalesce):
    """tests/test_backend_procs.py's seeded random DAGs (waits, stealing,
    migration, coalescing) on 4 worker processes."""
    desc = random_program(random.Random(seed))
    kw = dict(nw=4, levels=[1, 2], steal=steal, migrate_threshold=migrate, coalesce=coalesce)
    want = _serial(build_wait_app(desc))
    rt, _ = _procs(port_core, build_wait_app(desc), **kw)
    jax_rt, _ = _procs(jax_core, jax_threads_tests.build_wait_app(desc), **kw)
    assert rt.labelled_storage() == want == jax_rt.labelled_storage()


VALUES = {"f32": np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32),
          "bf16": np.random.default_rng(1).standard_normal((4, 4)).astype(np.float32),
          "i64": np.random.default_rng(2).integers(-2**40, 2**40, (7,))}


def _tensor(name):
    x = torch.from_numpy(VALUES[name])
    return x.to(torch.bfloat16) if name == "bf16" else x


def _tensor_app(ctx, root):
    oids = {name: ctx.alloc(64, root, label=name) for name in VALUES}
    for name, o in oids.items():
        ctx.spawn(lambda c, oo, n=name: c.write(oo, {"t": _tensor(n), "twice": [_tensor(n)] * 2}),
                  [Out(o)])
    yield ctx.wait([InOut(root)])


def test_tensors_cross_the_wire_bit_for_bit():
    rt, rep = _procs(port_core, _tensor_app)
    store = rt.labelled_storage()
    for name in VALUES:
        want = _tensor(name)
        for got in (store[name]["t"], *store[name]["twice"]):
            assert got.device.type == "cpu" and got.dtype == want.dtype
            assert torch.equal(got, want), name
    assert rep.wire_summary()["total_bytes"] > 0


def test_workers_are_spawned(monkeypatch):
    """The port's rule: spawn, whatever this process has loaded."""
    import multiprocessing
    methods, get_context = [], multiprocessing.get_context

    def spy(method=None):
        methods.append(method)
        return get_context(method)

    monkeypatch.setattr(multiprocessing, "get_context", spy)
    assert backend_procs.START_METHOD == "spawn"
    rt, _ = _procs(port_core, pipeline_app)
    assert methods == ["spawn"]
    assert rt.labelled_storage() == _serial(pipeline_app)


FORK_RUN = """
import random, sys
sys.path.insert(0, {tests!r})
from repro_torch.core import SerialRuntime, Myrmics, backend_procs
import test_torch_procs as t
backend_procs.START_METHOD = "fork"
app = t.build_wait_app(t.random_program(random.Random(5)))
sr = SerialRuntime(); sr.run(app)
rt = Myrmics(n_workers=2, sched_levels=[1], backend="procs", max_wall_s=60.0)
rep = rt.run(app)
assert rep.tasks_done == rep.tasks_spawned
assert rt.labelled_storage() == sr.labelled_storage()
print("forked ok")
"""


def test_forced_fork_runs_in_a_fresh_process():
    """The original's start method, forced, in a process that has run no
    torch operation (a fork after torch's CPU threads have run can hang
    the children) and has no CUDA."""
    r = subprocess.run([sys.executable, "-c", FORK_RUN.format(tests=str(ROOT / "tests"))],
                       cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0 and "forked ok" in r.stdout, r.stderr


def _meta_app(ctx, root):
    o = ctx.alloc(8, root, label="o")
    ctx.spawn(lambda c, oo: c.write(oo, {"w": torch.empty(2, device="meta")}), [Out(o)])
    yield ctx.wait([InOut(root)])


def test_a_tensor_off_the_cpu_is_refused():
    rt = port_core.Myrmics(n_workers=2, sched_levels=[1], backend="procs", max_wall_s=60.0)
    with pytest.raises(ValueError, match="hold CPU tensors"):
        rt.run(_meta_app)


def _boom_app(ctx, root):
    def boom(c, oid):
        raise PermissionError("task body failed in the worker process")

    o = ctx.alloc(8, root, label="o")
    ctx.spawn(boom, [Out(o)])
    yield ctx.wait([InOut(root)])


def test_task_error_propagates():
    rt = port_core.Myrmics(n_workers=2, sched_levels=[1], backend="procs", max_wall_s=60.0)
    with pytest.raises(PermissionError, match="task body failed"):
        rt.run(_boom_app)


def test_report_has_wire_and_process_stats():
    _, rep = _procs(port_core, pipeline_app)
    wire = rep.wire_summary()
    assert wire["total_frames"] > 0 and wire["total_bytes"] > 0
    assert {"x_exec", "x_complete"} <= set(wire["per_kind"])
    procs = rep.proc_summary()
    assert set(procs) == {"w0", "w1"}
    assert all(st["pid"] > 0 and st["frames_out"] > 0 for st in procs.values())


def test_both_receives_of_the_wire_tool_deliver_a_frame_intact():
    """``launch/time_wire.py`` times the port's receive against the
    original's; both must deliver the frame."""
    from repro_torch.launch import time_wire
    rows = time_wire.main(["--mb", "1"])
    assert [r["receive"] for r in rows] == ["one_buffer", "by_chunks"]
    assert all(r["intact"] and r["frame_bytes"] > 2**20 for r in rows)
