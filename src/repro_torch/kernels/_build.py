"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

The sources under ``csrc/`` have a plain C interface, so they compile in
seconds without PyTorch's headers.  Each ``.cu`` file is compiled to an
object by its own ``nvcc`` process, all started together, and the objects
are linked into one shared library under ``build/repro_torch/<key>/`` at
the root of the checkout, beside each source's ``ptxas`` report
(``<stem>.ptxas.txt``: registers, spills and stack of every kernel).  The
key is a hash of the sources and flags, so a second process (or a second
run) loads the library already built.  The build happens at first use,
never at import, and once per process: a lock holds concurrent first
launches (the Myrmics threads backend runs tasks on several threads)
until the one build and load are done.  The wrappers count their
launches through ``count_launch``, under a lock of its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
COMPILE_FLAGS = ["-Xptxas", "-v"]   # ptxas reports registers and spills on stderr

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# argtypes of each C entry point; every pointer and the stream are c_void_p
SIGNATURES = {
    "flash_attention_fwd": [I, I, P, P, P, P, P, I, I, I, I, I]
                           + [LL] * 12 + [I, I, I, F, P],
    "decode_attention": [I, I, P, P, P, P, I, P, I, I, I, I, I]
                        + [LL] * 10 + [F, P],
    "flash_attention_bwd": [I, I] + [P] * 11 + [I] * 5 + [LL] * 24 + [I, I, F, P],
    "mamba_scan": [I, I] + [P] * 9 + [I, I, I] + [LL] * 8 + [P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def _key() -> str:
    """Hash of the flags and of every file under csrc/ (headers too)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + COMPILE_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this exact source has not been built yet and
    return the library's path.  A failed ``nvcc`` raises with its stderr."""
    sources = sorted(CSRC.glob("*.cu"))
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / "libkernels.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = str(os.getpid())
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *COMPILE_FLAGS, "-c", str(src),
                               "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objs)]
    errors = []
    for src, proc in zip(sources, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} (rc {proc.returncode}):\n{err}")
        else:
            (out_dir / f"{src.stem}.ptxas.txt").write_text(err)
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = out_dir / f"libkernels.{tag}.so"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed (rc {link.returncode}):\n{link.stderr}")
    os.replace(tmp, lib)          # atomic: a concurrent builder sees all or nothing
    for obj in objs:
        obj.unlink()
    return lib


_LIBRARY: ctypes.CDLL | None = None
_LIBRARY_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  Callers on other
    threads wait for that build instead of starting their own."""
    global _LIBRARY
    with _LIBRARY_LOCK:
        if _LIBRARY is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = [I]
            lib.cuda_error_string.restype = ctypes.c_char_p
            _LIBRARY = lib
        return _LIBRARY


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``: a read-modify-write, so under a
    lock, or two threads launching at once could lose a count."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg}) at launch")
