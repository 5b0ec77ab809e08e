"""Serial elision of the Myrmics programming model.

Every spawn runs inline (depth-first) at the spawn point — the model's
defining semantics [6].  The property tests compare the distributed
runtime's labelled storage against this oracle bit-for-bit.

Both programming surfaces are supported, lowered exactly as the
distributed runtime lowers them: ``@task``-decorated functions with
annotated signatures (declarative API) and plain callables with
hand-assembled ``list[Arg]`` footprints (legacy shim) — so the
serial-equivalence property covers both front ends.
"""

from __future__ import annotations

from typing import Any, Callable

from .api import ObjRef, RegionRef, active_ctx, free_nid, nid_of, value_nid
from .regions import MODE_READ, MODE_WRITE, ROOT_RID, Directory
from .runtime import Arg, WaitSpec, _lower_spawn


class SerialContext:
    """Inline (depth-first) execution context: the model's serial
    semantics.  Used as the determinism oracle in property tests.

    ``args`` is the lowered footprint of the activation (None for the
    program entry, which implicitly holds the root region read-write):
    with ``SerialRuntime(sanitize=True)`` every storage access is
    validated against it — the serial half of the dynamic sanitizer.
    Race detection needs no shadow here: serial elision *is* the
    ordering the distributed backends are checked against."""

    def __init__(self, rt: "SerialRuntime", depth: int = 0,
                 args: "list[Arg] | None" = None):
        self.rt = rt
        self.depth = depth
        self.args = args
        self.cursor = 0.0
        self.worker_id = "serial"
        self.now = 0.0

    def _check(self, nid: int, mode: str) -> None:
        rt = self.rt
        if not rt.sanitize:
            return
        rt.accesses_checked += 1
        if self.args is None:      # program entry: holds the root r/w
            return
        for a in self.args:
            if a.safe or a.notransfer:
                continue
            if mode == MODE_WRITE and a.mode != MODE_WRITE:
                continue
            if rt.dir.is_ancestor_or_self(a.nid, nid):
                return
        rt.violations += 1
        raise PermissionError(
            f"serial task (depth {self.depth}) has no {mode}-covering "
            f"argument for node {nid}")

    def compute(self, cycles: float) -> None:
        pass

    def ralloc(self, parent_rid: int | RegionRef = ROOT_RID,
               level_hint: int = 10**9,
               label: str | None = None) -> RegionRef:
        rid = self.rt.dir.new_region(nid_of(parent_rid), "serial", level_hint)
        if label is not None:
            self.rt.labels[rid] = label
        return RegionRef(rid, label, self.rt.dir)

    def alloc(self, size: int, rid: int | RegionRef = ROOT_RID,
              label: str | None = None) -> ObjRef:
        oid = self.rt.dir.new_object(nid_of(rid), "serial", size)
        if label is not None:
            self.rt.labels[oid] = label
        return ObjRef(oid, label, self.rt.dir)

    def balloc(self, size: int, rid: int | RegionRef, num: int,
               label: str | None = None) -> list[ObjRef]:
        refs = []
        for i in range(num):
            ref = self.alloc(size, rid,
                             f"{label}[{i}]" if label is not None else None)
            refs.append(ref)
        return refs

    def free(self, oid: int | ObjRef) -> None:
        for nid in self.rt.dir.free(free_nid(oid, False, "free")):
            self.rt.storage.pop(nid, None)

    def rfree(self, rid: int | RegionRef) -> None:
        for nid in self.rt.dir.free(free_nid(rid, True, "rfree")):
            self.rt.storage.pop(nid, None)

    def read(self, oid: int | ObjRef) -> Any:
        nid = value_nid(oid, self.rt.dir, "read")
        self._check(nid, MODE_READ)
        return self.rt.storage.get(nid)

    def write(self, oid: int | ObjRef, value: Any) -> None:
        nid = value_nid(oid, self.rt.dir, "write")
        self._check(nid, MODE_WRITE)
        self.rt.storage[nid] = value

    def spawn(self, fn: Callable | None, *args, duration: float = 0.0,
              name: str | None = None, **kwargs) -> None:
        fn, largs, call = _lower_spawn(fn, args, kwargs)
        if fn is None:
            return
        sub = SerialContext(self.rt, self.depth + 1, largs)
        if call is not None:
            pos, kw = call
        else:
            pos = [a.value if a.safe
                   else (a.ref if a.ref is not None else a.nid)
                   for a in largs]
            kw = {}
        with active_ctx(sub):
            result = fn(sub, *pos, **kw)
            if hasattr(result, "__next__"):
                for _ in result:
                    pass

    def wait(self, args: list[Arg]) -> WaitSpec:
        return WaitSpec(args or [])


class SerialRuntime:
    """Serial elision of the Myrmics program: every spawn runs inline at
    the spawn point (the programming model's defining semantics [6])."""

    def __init__(self, sanitize: bool = False) -> None:
        self.dir = Directory(root_owner="serial")
        self.root = RegionRef(ROOT_RID, "root", self.dir)
        self.storage: dict[int, Any] = {}
        self.labels: dict[int, str] = {}
        #: footprint sanitizer (mirrors ``Myrmics(sanitize=True)``):
        #: validate every access against the activation's footprint
        self.sanitize = sanitize
        self.accesses_checked = 0
        self.violations = 0

    def run(self, main_fn: Callable, *extra: Any) -> dict[int, Any]:
        from .api import TaskFn
        if isinstance(main_fn, TaskFn):
            main_fn = main_fn.fn
        ctx = SerialContext(self)
        with active_ctx(ctx):
            result = main_fn(ctx, self.root, *extra)
            if hasattr(result, "__next__"):
                for _ in result:
                    pass
        return self.storage

    def labelled_storage(self) -> dict[str, Any]:
        return {
            self.labels[nid]: v for nid, v in self.storage.items()
            if nid in self.labels
        }
