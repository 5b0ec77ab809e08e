"""Step checkpointing: the port's own copy of ``repro.checkpoint.store``,
without JAX or ``ml_dtypes``.

Layout, the same as the JAX store's, so a checkpoint written by either
package restores in the other:  ``<dir>/step_<n>/`` with one
``leaf_NNNNN.npy`` per leaf, numbered in sorted key order, and
``manifest.json`` mapping each key to its file, shape and dtype name.
Keys are ``repro_torch.tree.flatten_with_keys`` paths, which equal the
JAX store's (``opt/m/blocks/wq``).  bf16 and float8 leaves are stored as
their unsigned-integer bit patterns under the dtype's name.  A step is
written into ``step_<n>.tmp`` and committed by renaming it, so a crash
mid-save never corrupts the latest restore point.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten_with_keys, unflatten_like

# dtype name -> (torch dtype, torch and numpy types of its stored bit pattern)
_EXOTIC = {"bfloat16": (torch.bfloat16, torch.uint16, np.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
           "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8)}


def _to_savable(x: Any) -> tuple[np.ndarray, str]:
    """A leaf (tensor, numpy array or scalar) as a numpy array on the host
    and the dtype name the manifest records."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        name = str(x.dtype).removeprefix("torch.")
        if name in _EXOTIC:
            return x.contiguous().view(_EXOTIC[name][1]).numpy(), name
        return x.numpy(), name
    arr = np.asarray(x)
    return arr, str(arr.dtype)


def _from_saved(arr: np.ndarray, dtype_name: str,
                device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr, order="C")          # keeps 0-d leaves 0-d
    if dtype_name in _EXOTIC:
        dt, _, bits = _EXOTIC[dtype_name]
        return torch.from_numpy(arr.view(bits)).view(dt).to(device)
    return torch.from_numpy(arr).to(device)


def _write(directory: str, step: int, host: dict[str, tuple[np.ndarray, str]],
           extra: dict | None) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for i, (key, (arr, dtype_name)) in enumerate(sorted(host.items())):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype_name}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async_thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------

    @staticmethod
    def _snapshot(state: Any) -> dict[str, tuple[np.ndarray, str]]:
        return {k: _to_savable(v) for k, v in flatten_with_keys(state)}

    def save(self, step: int, state: Any, extra: dict | None = None) -> str:
        final = _write(self.dir, step, self._snapshot(state), extra)
        self._gc()
        return final

    def save_async(self, step: int, state: Any,
                   extra: dict | None = None) -> None:
        """Copy to the host now (the device-to-host copy), write in a
        thread: the train loop goes on while the disk write happens."""
        self.wait()
        host = self._snapshot(state)

        def work():
            _write(self.dir, step, host, extra)
            self._gc()

        self._async_thread = threading.Thread(target=work, daemon=True)
        self._async_thread.start()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """Restore into the structure of ``like``; each leaf goes to the
        device of ``like``'s tensor there (the CPU for a leaf that is not
        a tensor), with the dtype it was saved in."""
        if shardings is not None:
            raise NotImplementedError(
                "restore onto shardings is not ported yet: ROADMAP.md Queue 1, "
                "'Sharding and meshes'")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        values = []
        for key, leaf in flatten_with_keys(like):
            info = manifest["leaves"][key]
            device = leaf.device if isinstance(leaf, torch.Tensor) else torch.device("cpu")
            values.append(_from_saved(np.load(os.path.join(d, info["file"])),
                                      info["dtype"], device))
        return unflatten_like(like, values)

    def extra(self, step: int) -> dict:
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f).get("extra", {})
