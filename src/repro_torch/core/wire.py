"""Wire marshalling for the process backend (paper SIV: messages only).

The procs substrate (:mod:`.backend_procs`) moves every cross-process
interaction — dispatched task descriptors, footprint snapshots,
marshalled ``sys_*`` request/reply pairs, write-backs — as
length-prefixed binary frames built by :meth:`.substrate.Message.to_wire`.
The frame *payload* is produced here: a pickle stream extended with the
reducers the runtime's objects need to cross an address-space boundary:

* **task functions** — app task bodies are typically closures defined
  inside an app builder, which stdlib pickle refuses (`Can't pickle
  <locals> function`).  Functions that are not importable by qualified
  name ship *by value*: marshalled code object + closure cell values +
  defaults, rebuilt against the defining module's ``__dict__`` on the
  other side (the worker processes are forked from the runtime process,
  so every defining module is already imported there).  Importable
  module-level functions ship by reference as usual.
* **typed handles** — :class:`~.api.Ref` subclasses ship as
  ``(nid, label)`` and rebuild without a directory: inside a worker
  process, ``ref.read()``/``ref.write()`` route through the ambient
  child task context, never through the (host-only) directory.
* **@task wrappers** — :class:`~.api.TaskFn` ships as its wrapped
  function + name and re-derives its footprint specs from the signature
  on arrival.

Anything that genuinely cannot cross (generators, the host-side
:class:`~.runtime.Task` bookkeeping objects, OS handles like locks and
open files) raises :class:`WireError` at serialization time — the
static companion check is the ``unpicklable-capture`` rule in
:mod:`repro.analysis.footprint_lint`.

:func:`payload_size` is the shared cheap estimator the threads backend
uses to charge marshalled ``sys_*`` call arguments into the per-kind
message accounting (so sim/threads/procs byte columns are comparable
without paying a real serialization per call).
"""

from __future__ import annotations

import importlib
import io
import marshal
import pickle
import sys
import types
from typing import Any

from .api import Arg, Ref, TaskFn


class WireError(Exception):
    """An object cannot be marshalled across the process boundary."""


_EMPTY_CELL = "__myrmics_empty_cell__"


def _lookup_qualname(module: str, qualname: str):
    """Resolve ``module.qualname`` to the live object, or None when the
    path is not importable (``<locals>`` scopes, deleted names)."""
    obj = sys.modules.get(module)
    if obj is None:
        return None
    for part in qualname.split("."):
        if part == "<locals>":
            return None
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def _rebuild_function(code_bytes: bytes, module: str, name: str,
                      qualname: str, defaults, kwdefaults, cell_values,
                      annotations=None):
    code = marshal.loads(code_bytes)
    mod = sys.modules.get(module)
    if mod is None:     # spawned (not forked) child: import on demand
        try:
            mod = importlib.import_module(module)
        except ImportError:
            mod = None
    g = mod.__dict__ if mod is not None else {"__builtins__": __builtins__}
    closure = None
    if cell_values is not None:
        closure = tuple(
            types.CellType() if v == (_EMPTY_CELL,) else types.CellType(v[0])
            for v in cell_values
        )
    fn = types.FunctionType(code, g, name, None, closure)
    if defaults:
        fn.__defaults__ = tuple(defaults)
    if kwdefaults:
        fn.__kwdefaults__ = dict(kwdefaults)
    if annotations:
        fn.__annotations__ = dict(annotations)
    fn.__qualname__ = qualname
    fn.__module__ = module
    return fn


def _reduce_function(fn: types.FunctionType):
    cells = None
    if fn.__closure__ is not None:
        cells = []
        for cell in fn.__closure__:
            try:
                cells.append((cell.cell_contents,))
            except ValueError:        # unassigned cell (recursive def)
                cells.append((_EMPTY_CELL,))
    try:
        code_bytes = marshal.dumps(fn.__code__)
    except ValueError as e:
        raise WireError(
            f"cannot marshal code of {fn.__qualname__}: {e}") from e
    return (_rebuild_function,
            (code_bytes, fn.__module__, fn.__name__, fn.__qualname__,
             fn.__defaults__, fn.__kwdefaults__, cells,
             getattr(fn, "__annotations__", None)))


def _rebuild_taskfn(fn, name):
    return TaskFn(fn, name=name)


class _WirePickler(pickle.Pickler):
    """Pickler with the runtime's cross-process reducers installed."""

    def reducer_override(self, obj):
        t = type(obj)
        if t is types.FunctionType:
            if _lookup_qualname(obj.__module__, obj.__qualname__) is obj:
                return NotImplemented       # importable: ship by reference
            return _reduce_function(obj)
        if t is TaskFn:
            return (_rebuild_taskfn, (obj.fn, obj.__name__))
        if isinstance(obj, Ref):
            return (t, (obj.nid, obj.label))
        if t is types.ModuleType:
            # modules land in closure cells of task bodies that do a
            # local `import jax` — ship by name, re-import on arrival
            return (importlib.import_module, (obj.__name__,))
        if t is types.GeneratorType:
            raise WireError(
                "a generator cannot cross the process boundary (suspended "
                "task activations stay resident on their worker process)")
        if t.__name__ == "Task" and t.__module__.endswith(".runtime"):
            raise WireError(
                "host-side Task bookkeeping objects never ship over the "
                "wire: send a task descriptor tuple instead")
        return NotImplemented


def dumps(obj: Any) -> bytes:
    """Serialize ``obj`` for the wire; :class:`WireError` on anything
    that cannot cross the process boundary."""
    buf = io.BytesIO()
    try:
        _WirePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    except WireError:
        raise
    except (TypeError, AttributeError, pickle.PicklingError) as e:
        raise WireError(f"unmarshallable payload: {e}") from e
    return buf.getvalue()


def loads(data: bytes) -> Any:
    """Inverse of :func:`dumps`; :class:`WireError` on corrupt input."""
    try:
        return pickle.loads(data)
    except WireError:
        raise
    except Exception as e:
        raise WireError(f"malformed wire payload: {e}") from e


# -- cheap argument-size estimation (threads-backend call accounting) ---------


def payload_size(obj: Any, _depth: int = 4) -> int:
    """Estimated wire footprint of a marshalled-call argument tuple, in
    bytes.  Deliberately cheap (no serialization): numbers are one
    machine word, strings/bytes their length, containers recurse a few
    levels, runtime bookkeeping objects are flat constants.  Used by the
    threads backend to charge ``sys_*`` call payloads into the per-kind
    message table so its byte columns are comparable with the procs
    backend's real frame sizes."""
    if obj is None or obj is True or obj is False:
        return 1
    if isinstance(obj, (int, float)):
        return 8
    if isinstance(obj, (str, bytes, bytearray)):
        return len(obj)
    if isinstance(obj, Ref):
        return 16
    if isinstance(obj, Arg):
        return 16 + (payload_size(obj.value, _depth - 1)
                     if _depth > 0 else 8)
    if _depth <= 0:
        return 8
    if isinstance(obj, (list, tuple, set, frozenset)):
        return 8 + sum(payload_size(v, _depth - 1) for v in obj)
    if isinstance(obj, dict):
        return 8 + sum(payload_size(k, _depth - 1)
                       + payload_size(v, _depth - 1)
                       for k, v in obj.items())
    if getattr(obj, "dep_args", None) is not None:   # Task-shaped
        return 32 + payload_size(tuple(obj.args), _depth - 1)
    return 32
