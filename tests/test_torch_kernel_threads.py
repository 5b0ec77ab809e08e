"""The kernels' launch counters and their build under threads: the
Myrmics threads backend runs gradient tasks on several threads at once,
so a count must not be lost and the library must be built once."""

import re
import sys
import threading
import time
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan  # noqa: E402

WRAPPERS = [flash_attention, flash_attention_bwd, decode_attention, mamba_scan]
KERNELS = Path(_build.__file__).parent
N_THREADS, PER_THREAD = 8, 2000


class _YieldingInt(int):
    """A count whose addition lets other threads run between the read of
    ``launches`` and the write back, as a free-threaded interpreter may."""

    def __add__(self, other):
        time.sleep(0)
        return _YieldingInt(int(self) + other)


def _run_threads(target, n=N_THREADS, timeout=30.0):
    """Start ``n`` threads on ``target`` behind one barrier, with a short
    switch interval, and join them with a timeout."""
    barrier = threading.Barrier(n)
    threads = [threading.Thread(target=lambda: (barrier.wait(), target())) for _ in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)


@pytest.mark.parametrize("wrapper", WRAPPERS, ids=lambda w: w.__name__)
def test_no_launch_count_is_lost_under_threads(wrapper, monkeypatch):
    monkeypatch.setattr(wrapper, "launches", _YieldingInt(0))

    def bump():
        for _ in range(PER_THREAD):
            _build.count_launch(wrapper)

    _run_threads(bump)
    assert wrapper.launches == N_THREADS * PER_THREAD


@pytest.mark.parametrize("wrapper", WRAPPERS, ids=lambda w: w.__name__)
def test_each_wrapper_counts_through_the_lock(wrapper):
    """A wrapper adds to its count in one place, through ``count_launch``."""
    src = (KERNELS / f"{wrapper.__module__.rsplit('.', 1)[1]}.py").read_text()
    assert src.count(f"_build.count_launch({wrapper.__name__})") == 1
    assert not re.search(r"\.launches\s*\+=", src)


def test_concurrent_first_launches_build_once(monkeypatch, tmp_path):
    """Eight threads ask for the library at once: one slow build, one load,
    and every thread gets the same library."""
    builds, loads = [], []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.2)
        return tmp_path / "libkernels.so"

    def fake_cdll(path):
        loads.append(path)
        names = list(_build.SIGNATURES) + ["cuda_error_string"]
        return types.SimpleNamespace(**{n: types.SimpleNamespace() for n in names})

    monkeypatch.setattr(_build, "_LIBRARY", None)
    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    got = []
    _run_threads(lambda: got.append(_build.library()))
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == N_THREADS and all(lib is got[0] for lib in got)
    assert got[0].flash_attention_fwd.restype is _build.ctypes.c_int
