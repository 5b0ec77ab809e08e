"""The port's copy of the Myrmics runtime (``repro_torch.core``) against
the original (``repro.core``).

1. Source: each copied module is the original's text, with
   ``repro.core.`` named ``repro_torch.core.`` in docstrings, except the
   two refusals in ``runtime.py`` (``backend="procs"`` and ``faults=``),
   listed here line by line.
2. Behaviour on ``backend="sim"``: seeded random programs give the same
   run report (virtual cycles, events, messages by kind, DMA bytes) and
   the same labelled storage on both packages.
3. ``backend="threads"``: seeded random programs end with the port's
   serial oracle's storage.
"""

import dataclasses
import difflib
import io
import random
import tokenize
import types
from pathlib import Path

import pytest

import repro.core as jax_core
import repro_torch.core as port_core
from test_backend_threads import build_wait_app, random_program
from test_core_api import declarative_app, legacy_app

ROOT = Path(__file__).resolve().parents[1]
ORIG, COPY = ROOT / "src" / "repro" / "core", ROOT / "src" / "repro_torch" / "core"
MODULES = ["sim", "substrate", "regions", "deps", "sched", "api", "runtime",
           "sched_agent", "worker_agent", "alloc", "serial", "trace", "payload",
           "wire", "backend_threads", "__init__"]
NOT_COPIED = ["backend_procs", "faults", "placement"]

# runtime.py: the original's lines -> the copy's, the only hunks allowed
RUNTIME_HUNKS = [
    (['            from .backend_procs import ProcSubstrate, ProcWorkerAgent\n',
      '            self.sub = ProcSubstrate(self.hier, max_wall_s=max_wall_s)\n',
      '            self.worker_agent = ProcWorkerAgent(self)\n',
      '            self.sub.runtime = self\n',
      '            self.sub.agent = self.worker_agent\n'],
     ['            raise NotImplementedError(\n',
      '                "backend=\'procs\' is not ported yet: ROADMAP.md Queue 1, \'Slice 5: "\n',
      '                "training of the dense family under the Myrmics runtime\' (item 7b)")\n']),
    (['            from .faults import FaultInjector, normalize_faults\n',
      '            self.fault_plan = normalize_faults(faults)\n',
      '            self.fault_injector = FaultInjector(self, self.fault_plan)\n'],
     ['            raise NotImplementedError(\n',
      '                "faults= is not ported yet: ROADMAP.md Queue 1, \'Slice 5: training "\n',
      '                "of the dense family under the Myrmics runtime\' (item 11)")\n']),
]


def _renamed(text: str) -> str:
    return text.replace("repro.core.", "repro_torch.core.")


def _docstring_lines(text: str) -> set[int]:
    """Line numbers covered by string and comment tokens."""
    out = set()
    for tok in tokenize.generate_tokens(io.StringIO(text).readline):
        if tok.type in (tokenize.STRING, tokenize.COMMENT):
            out |= set(range(tok.start[0], tok.end[0] + 1))
    return out


def _hunks(a: list[str], b: list[str]) -> list[tuple[list[str], list[str]]]:
    sm = difflib.SequenceMatcher(a=a, b=b, autojunk=False)
    return [(a[i1:i2], b[j1:j2]) for op, i1, i2, j1, j2 in sm.get_opcodes()
            if op != "equal"]


@pytest.mark.parametrize("name", MODULES)
def test_copy_is_the_original_text(name):
    orig = (ORIG / f"{name}.py").read_text()
    copy = (COPY / f"{name}.py").read_text()
    # the renaming touches docstrings and comments only
    renamed_lines = {i + 1 for i, line in enumerate(orig.splitlines())
                     if "repro.core." in line}
    assert renamed_lines <= _docstring_lines(orig), name
    hunks = _hunks(_renamed(orig).splitlines(True), copy.splitlines(True))
    assert hunks == (RUNTIME_HUNKS if name == "runtime" else []), name


def test_copy_holds_every_module_it_imports_and_no_other():
    assert sorted(p.stem for p in COPY.glob("*.py")) == sorted(MODULES)
    assert not any((COPY / f"{n}.py").exists() for n in NOT_COPIED)


def test_runtime_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP.md .*Slice 5.*7b"):
        port_core.Myrmics(n_workers=2, backend="procs")
    with pytest.raises(NotImplementedError, match="ROADMAP.md .*Slice 5.*item 11"):
        port_core.Myrmics(n_workers=2, faults={"kill": []})


def _app_on(core, seed):
    """``build_wait_app``'s program for ``seed``, its annotations taken
    from ``core`` (the function runs with ``core``'s In/Out/InOut)."""
    fn = build_wait_app
    env = {**fn.__globals__, "In": core.In, "Out": core.Out, "InOut": core.InOut}
    return types.FunctionType(fn.__code__, env)(random_program(random.Random(seed)))


def _fixed_app_on(core, fn):
    """``fn`` run with ``core``'s annotations and ``@task``."""
    names = ("In", "Out", "InOut", "Safe", "task")
    env = {**fn.__globals__, **{n: getattr(core, n) for n in names}}
    return types.FunctionType(fn.__code__, env)


def _run(core, app, nw, levels, **kw):
    rt = core.Myrmics(n_workers=nw, sched_levels=levels, **kw)
    rep = rt.run(app)
    return dataclasses.asdict(rep), rt.labelled_storage()


CASES = [(1, [1]), (4, [1]), (8, [1, 2])]      # tests/test_core_api.py's


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("nw,levels", CASES)
def test_sim_random_programs_identical_on_both_packages(seed, nw, levels):
    want_rep, want_store = _run(jax_core, _app_on(jax_core, seed), nw, levels)
    got_rep, got_store = _run(port_core, _app_on(port_core, seed), nw, levels)
    assert got_store == want_store
    assert got_rep == want_rep            # cycles, events, messages, DMA bytes
    assert got_rep["tasks_done"] == got_rep["tasks_spawned"]


@pytest.mark.parametrize("app", [legacy_app, declarative_app], ids=["legacy", "declarative"])
@pytest.mark.parametrize("nw,levels", CASES)
def test_sim_core_api_apps_identical_on_both_packages(app, nw, levels):
    """tests/test_core_api.py's two front ends, on either package."""
    want = _run(jax_core, _fixed_app_on(jax_core, app), nw, levels)
    assert _run(port_core, _fixed_app_on(port_core, app), nw, levels) == want


@pytest.mark.parametrize("seed", range(3))
def test_threads_random_programs_match_the_serial_oracle(seed):
    app = _app_on(port_core, seed)
    sr = port_core.SerialRuntime()
    sr.run(app)
    rt = port_core.Myrmics(n_workers=2, sched_levels=[1, 2], backend="threads",
                           max_wall_s=20.0)
    rep = rt.run(app)
    assert rep.tasks_spawned == rep.tasks_done, "program hung"
    assert rt.labelled_storage() == sr.labelled_storage()


@pytest.mark.parametrize("backend", ["sim", "threads"])
def test_kills_fail_on_the_faults_module_not_yet_ported(backend):
    """``kill_scheduler`` and ``kill_worker`` reach ``faults`` (ROADMAP
    item 11), which the copy does not hold yet: each fails, and no kill is
    dropped in silence.  On threads a worker's kill runs in its
    scheduler's context, so it fails the run."""
    def make():
        return port_core.Myrmics(n_workers=2, sched_levels=[1], backend=backend,
                                 max_wall_s=20.0)
    with pytest.raises(ModuleNotFoundError, match=r"repro_torch\.core\.faults"):
        make().kill_scheduler("s0.0")
    rt = make()
    with pytest.raises(ModuleNotFoundError, match=r"repro_torch\.core\.faults"):
        rt.kill_worker("w1")
        rt.run(_app_on(port_core, 0))
