"""Parameters across frameworks: a JAX parameter tree, given as nested
dicts of numpy arrays, to the port's tensors, key by key."""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(arr: np.ndarray, device: str | torch.device) -> torch.Tensor:
    """One array to a tensor of the same dtype.  bf16 arrives as an
    ``ml_dtypes`` array, which torch cannot read: it crosses as its
    uint16 bit pattern, with no import of ``ml_dtypes``."""
    arr = np.array(arr, order="C")        # a writable copy the tensor owns
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: dict, device: str | torch.device) -> dict:
    """Nested dicts of numpy arrays -> the same nesting of tensors."""
    return {k: params_from_numpy(v, device) if isinstance(v, dict)
            else tensor_from_numpy(v, device) for k, v in tree.items()}
