"""Real compute payloads for the threaded backend.

Virtual-mode benchmarks model compute as ``duration=`` cycle charges;
on ``backend="threads"`` the same apps attach a *real* payload so that
wall-clock scaling is measurable.  The kernel must (a) release the GIL
so worker threads actually run in parallel, and (b) use a fixed amount
of single-threaded work per call so speedups come from the runtime's
parallelism, not from a library's internal thread pool (which BLAS
would smuggle in).  SHA-256 over a 1 MiB buffer satisfies both:
CPython's ``hashlib`` drops the GIL for large updates and hashes on
exactly one core.

``burn(cycles)`` converts a virtual-cycle budget into hash rounds via
``CYCLES_PER_ROUND`` so the virtual apps' work parameters carry over
unchanged to the real-payload variants.
"""

from __future__ import annotations

import hashlib

#: Virtual cycles represented by one 1 MiB hash round (~1 ms of real
#: single-core work): keeps real-payload runs of the default benchmark
#: grids in the seconds range.
CYCLES_PER_ROUND = 1_000_000.0

_BUF = b"\xa5" * (1 << 20)


def burn(cycles: float) -> int:
    """Do ``cycles`` worth of real, GIL-releasing, single-core work.

    Returns a digest-derived int so callers can write a value the
    serial oracle reproduces deterministically."""
    if cycles <= 0:
        return 0
    h = hashlib.sha256()
    for _ in range(max(1, round(cycles / CYCLES_PER_ROUND))):
        h.update(_BUF)
    return int.from_bytes(h.digest()[:8], "big")
