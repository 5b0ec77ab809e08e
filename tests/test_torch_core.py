"""The port's copy of the Myrmics runtime (``repro_torch.core``) against
the original (``repro.core``).

1. Source: each copied module is the original's text, with
   ``repro.core.`` named ``repro_torch.core.`` in docstrings, except the
   hunks listed here line by line: in ``faults.py`` the port's
   checkpoint store and torch payloads in region snapshots, in
   ``backend_procs.py`` the start method (always spawn) and the refusal
   of a written tensor that is not on the CPU, in ``substrate.py`` and
   ``backend_procs.py`` 8-byte frame lengths (a frame may exceed 4 GiB),
   and in ``backend_procs.py`` a receive into one buffer (a frame of
   gigabytes arrives in linear time).  ``runtime.py`` is the
   original's text.
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
from repro_torch.core import In, InOut, Out  # noqa: F401  (_port_wait_app's globals)
from test_backend_threads import _descends, build_wait_app, random_program  # noqa: F401
from test_core_api import declarative_app, legacy_app

ROOT = Path(__file__).resolve().parents[1]
ORIG, COPY = ROOT / "src" / "repro" / "core", ROOT / "src" / "repro_torch" / "core"
MODULES = ["sim", "substrate", "regions", "deps", "sched", "api", "runtime",
           "sched_agent", "worker_agent", "alloc", "serial", "trace", "payload",
           "wire", "backend_threads", "backend_procs", "faults", "__init__"]
NOT_COPIED = ["placement"]


# the only changes from the original's text (after the docstring
# renaming), per module: each ``old`` occurs once in the original and is
# replaced by ``new``
HUNKS = {
    "faults": [
        (":mod:`repro.checkpoint.store`'s atomic-commit",
         ":mod:`repro_torch.checkpoint.store`'s atomic-commit"),
        ('        return np.asarray(v), "float"\n    tag = "array"\n',
         '        return np.asarray(v), "float"\n'
         '    import torch\n'
         '    if isinstance(v, torch.Tensor):\n'
         '        # the store keeps bf16 as its bit pattern; np.asarray would refuse it\n'
         '        return v.detach().cpu(), "tensor"\n'
         '    tag = "array"\n'),
        ('    import numpy as np\n\n    arr = np.asarray(x)\n',
         '    import numpy as np\n\n'
         '    if tag in ("tensor", "array"):\n'
         '        return x        # a CPU tensor of the saved dtype, as the store restored it\n'
         '    arr = np.asarray(x)\n'),
        ('    return x            # "array": keep the device array as restored\n',
         '    return x\n'),
        (":mod:`repro.checkpoint.store`); when", ":mod:`repro_torch.checkpoint.store`); when"),
        ("checkpoint.store pulls in jax at module top",
         "checkpoint.store pulls in torch at module top"),
    ],
    "substrate": [
        ('_WIRE_LEN = struct.Struct(">I")\n',
         "# 8-byte lengths: a 4-byte one caps a frame at 4 GiB, and a full-width\n"
         "# model's parameters and moments ship in one frame\n"
         '_WIRE_LEN = struct.Struct(">Q")\n'),
    ],
    "backend_procs": [
        ('the same queued-but-undispatched rule as the other\nbackends.\n"""\n',
         'the same queued-but-undispatched rule as the other\nbackends.\n\n'
         "Start method: the original forks unless JAX is loaded (XLA's threads\n"
         "deadlock in a forked child); the port always spawns\n"
         "(``START_METHOD``).  A forked child cannot use the card once its parent\n"
         "has run ``cuInit``, and ``torch.cuda.is_available()`` runs it while\n"
         "``torch.cuda.is_initialized()`` stays false, so that check is not\n"
         "enough; ``import torch`` already maps ``libcuda``, so its\n"
         "presence says nothing either.  A child forked after torch has run CPU\n"
         "work on its OpenMP threads also hangs in its first parallel operation.\n"
         "Objects that cross the wire hold CPU tensors: a tensor on the card\n"
         "would be unpickled onto the card in the host, which would set up a\n"
         "CUDA context there, so a task that writes one fails.\n"
         '"""\n'),
        ('_LEN = struct.Struct(">I")\n',
         '_LEN = struct.Struct(">Q")      # 8 bytes, as substrate._WIRE_LEN\n'),
        ('def _recv_exact(sock: socket.socket, n: int) -> bytes | None:\n'
         '    """Read exactly ``n`` bytes; None on EOF."""\n'
         '    buf = bytearray()\n'
         '    while len(buf) < n:\n'
         '        try:\n'
         '            chunk = sock.recv(n - len(buf))\n'
         '        except OSError:\n'
         '            return None\n'
         '        if not chunk:\n'
         '            return None\n'
         '        buf += chunk\n'
         '    return bytes(buf)\n',
         'def _recv_exact(sock: socket.socket, n: int) -> bytearray | None:\n'
         '    """Read exactly ``n`` bytes; None on EOF.  Into one buffer: a\n'
         '    ``recv(n - got)`` per chunk allocates that many bytes each time,\n'
         '    which for a frame of gigabytes costs seconds a chunk."""\n'
         '    buf = bytearray(n)\n'
         '    view = memoryview(buf)\n'
         '    got = 0\n'
         '    while got < n:\n'
         '        try:\n'
         '            k = sock.recv_into(view[got:])\n'
         '        except OSError:\n'
         '            return None\n'
         '        if not k:\n'
         '            return None\n'
         '        got += k\n'
         '    return buf\n'),
        ('\n\ndef _wire_safe_exc(',
         '\n\n#: how worker processes start (module docstring)\n'
         'START_METHOD = "spawn"\n\n\n'
         'def _refuse_device_tensors(nid: int, value) -> None:\n'
         '    """Refuse a tensor on the card in a written value (module\n'
         '    docstring): it is never moved to the CPU quietly."""\n'
         '    torch = sys.modules.get("torch")\n'
         '    if torch is None:\n'
         '        return\n'
         '    todo = [value]\n'
         '    while todo:\n'
         '        v = todo.pop()\n'
         '        if isinstance(v, torch.Tensor):\n'
         '            if v.device.type != "cpu":\n'
         '                raise ValueError(\n'
         '                    f"write({nid}): a tensor on {v.device} on backend=\'procs\'; "\n'
         '                    "objects that cross the wire hold CPU tensors (move it "\n'
         '                    "with .cpu() in the task body)")\n'
         '        elif isinstance(v, dict):\n'
         '            todo.extend(v.values())\n'
         '        elif isinstance(v, (list, tuple)):\n'
         '            todo.extend(v)\n\n\n'
         'def _wire_safe_exc('),
        ('        # fork is the fast path: children inherit every imported module\n'
         '        # and the footprint-shipping pickles rebuild against them.  JAX,\n'
         '        # however, owns multithreaded XLA state that deadlocks in a\n'
         '        # forked child, so once jax is imported in this process the\n'
         '        # children must be spawned fresh (the socketpair end crosses via\n'
         "        # multiprocessing's fd-passing reduction).\n"
         '        start = "spawn" if "jax" in sys.modules else "fork"\n',
         '        start = START_METHOD\n'),
        ('def _recv_frame(sock: socket.socket) -> Message | None:\n'
         '    head = _recv_exact(sock, _LEN.size)\n'
         '    if head is None:\n'
         '        return None\n'
         '    (n,) = _LEN.unpack(head)\n'
         '    data = _recv_exact(sock, n)\n'
         '    if data is None:\n'
         '        return None\n'
         '    return Message.from_wire(data)\n',
         'def _recv_sized_frame(sock: socket.socket) -> tuple[Message | None, int]:\n'
         '    """A frame and its bytes on the wire, length prefix included: the\n'
         "    host's wire stats count what arrived, with no second pickling.\"\"\"\n"
         '    head = _recv_exact(sock, _LEN.size)\n'
         '    if head is None:\n'
         '        return None, 0\n'
         '    (n,) = _LEN.unpack(head)\n'
         '    data = _recv_exact(sock, n)\n'
         '    if data is None:\n'
         '        return None, 0\n'
         '    return Message.from_wire(data), _LEN.size + n\n\n\n'
         'def _recv_frame(sock: socket.socket) -> Message | None:\n'
         '    return _recv_sized_frame(sock)[0]\n'),
        ('                msg = _recv_frame(ch.sock)\n',
         '                msg, nbytes = _recv_sized_frame(ch.sock)\n'),
        ('            self._note_wire(msg.kind, len(msg.to_wire()) + _LEN.size,\n'
         '                            wid, outbound=False)\n',
         '            self._note_wire(msg.kind, nbytes, wid, outbound=False)\n'),
        ('        self._check(nid, MODE_WRITE)\n        self.child.store[nid] = value\n',
         '        self._check(nid, MODE_WRITE)\n'
         '        _refuse_device_tensors(nid, value)\n'
         '        self.child.store[nid] = value\n'),
    ],
}


def _patched(name: str, text: str) -> str:
    for old, new in HUNKS.get(name, []):
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    return text


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
    want = _patched(name, _renamed(orig))
    hunks = _hunks(want.splitlines(True), copy.splitlines(True))
    assert hunks == [], (name, hunks)


def test_copy_holds_every_module_it_imports_and_no_other():
    assert sorted(p.stem for p in COPY.glob("*.py")) == sorted(MODULES)
    assert not any((COPY / f"{n}.py").exists() for n in NOT_COPIED)


def test_runtime_runs_a_program_on_procs():
    """``backend="procs"`` (the refusal of the first copy is gone): a
    seeded random program ends with the serial oracle's storage."""
    app = _app_on(port_core, 0)
    sr = port_core.SerialRuntime()
    sr.run(app)
    rt = port_core.Myrmics(n_workers=2, sched_levels=[1], backend="procs", max_wall_s=60.0)
    rep = rt.run(_port_wait_app(0))
    assert rep.backend == "procs" and rep.tasks_done == rep.tasks_spawned
    assert rt.labelled_storage() == sr.labelled_storage()


def test_runtime_runs_a_program_with_a_fault_plan():
    """``faults=`` (the refusal of the first copy is gone): a plan with no
    kill arms the injector and changes no result."""
    from repro_torch.core.faults import FaultPlan
    app = _app_on(port_core, 1)
    want = _run(port_core, app, 2, [1])[1]
    rt = port_core.Myrmics(n_workers=2, sched_levels=[1], faults=FaultPlan())
    rep = rt.run(app)
    assert rep.fault_summary()["enabled"] is True
    assert rep.fault_summary()["workers_killed"] == 0
    assert rt.labelled_storage() == want


def _port_wait_app(seed):
    """``build_wait_app``'s program for ``seed`` with this module's globals
    (the port's In/Out/InOut): a procs worker rebuilds the app's
    functions against their module, so the annotations must be there."""
    fn = types.FunctionType(build_wait_app.__code__, globals(), "build_wait_app")
    return fn(random_program(random.Random(seed)))


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
def test_kills_reach_the_faults_copy(backend):
    """``kill_scheduler`` and ``kill_worker`` reach the copy of
    ``faults``: the root scheduler's death is refused by name, and a
    worker killed before the run leaves the serial oracle's storage."""
    from repro_torch.core.faults import SchedulerDiedError

    def make():
        return port_core.Myrmics(n_workers=2, sched_levels=[1], backend=backend,
                                 max_wall_s=20.0)
    with pytest.raises(SchedulerDiedError, match="root"):
        make().kill_scheduler("s0.0")
    app = _app_on(port_core, 0)
    sr = port_core.SerialRuntime()
    sr.run(app)
    rt = make()
    rt.kill_worker("w1")
    rep = rt.run(app)
    assert rep.tasks_done == rep.tasks_spawned
    assert "w1" in rt.dead_workers
    assert rt.labelled_storage() == sr.labelled_storage()
