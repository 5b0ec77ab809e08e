"""Selective scan (the Mamba recurrence): the CUDA kernel's wrapper and its
plain version.

``mamba_scan`` launches ``csrc/mamba_scan.cu`` for CUDA tensors and takes
``mamba_scan_plain`` for CPU tensors; there is no other path.  Both return
``(y, h_final)`` and accept an initial state ``h0``, which is what
``repro.kernels.ref.mamba_scan_ref`` returns and takes; the plain version
is the same step-by-step f32 loop.  The kernel is forward only: a
gradient through it on the card is later work, so under autograd it
raises instead of falling back to the plain version.
"""

from __future__ import annotations

import torch

from . import _build
from .flash_attention import DTYPE_CODES

STATE_DIMS = (4, 8, 16, 64)   # the kernel's instantiations of N
TRAINING_ITEM = "ROADMAP.md Queue 1, 'Slice 4: SSM training'"


def softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's softplus, ``logaddexp(x, 0)``: no threshold cut-off, unlike
    ``F.softplus``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def mamba_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                     h0: torch.Tensor | None = None):
    """x, dt: (Bt, S, Din); A: (Din, N); B, C: (Bt, S, N); D: (Din,);
    h0: (Bt, Din, N) or None (zeros).  dt is taken before the softplus,
    which is applied here.  Returns (y (Bt, S, Din) in x's dtype,
    h_final (Bt, Din, N) f32)."""
    bt, s, din = x.shape
    xf, dtf = x.float(), softplus(dt.float())
    Bf, Cf, Af, Df = B.float(), C.float(), A.float(), D.float()
    h = (torch.zeros((bt, din, A.shape[1]), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(s):
        dt_t, x_t = dtf[:, t], xf[:, t]
        h = torch.exp(dt_t[..., None] * Af) * h + (dt_t * x_t)[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]) + Df * x_t)
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bt, 0, din))
    return y.to(x.dtype), h


def _check(x, dt, A, B, C, D, h0):
    tensors = {"x": x, "dt": dt, "A": A, "B": B, "C": C, "D": D}
    if h0 is not None:
        tensors["h0"] = h0
    if not (x.is_cuda and all(t.device == x.device for t in tensors.values())):
        raise ValueError("the scan's inputs must lie on one CUDA device")
    if (x.dtype not in DTYPE_CODES
            or any(t.dtype != x.dtype for t in (dt, B, C))):
        raise TypeError(f"dtypes x {x.dtype}, dt {dt.dtype}, B {B.dtype}, C {C.dtype}: "
                        "need one of float32, bfloat16 for all four")
    if any(t.dtype != torch.float32 for n, t in tensors.items() if n in ("A", "D", "h0")):
        raise TypeError("A, D and h0 must be float32")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"shapes x {tuple(x.shape)}, A {tuple(A.shape)}: need "
                         "(Bt,S,Din) and (Din,N)")
    bt, s, din = x.shape
    n = A.shape[1]
    want = {"dt": (bt, s, din), "A": (din, n), "B": (bt, s, n), "C": (bt, s, n),
            "D": (din,), "h0": (bt, din, n)}
    for name, t in tensors.items():
        if name != "x" and tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, need {want[name]}")
    if n not in STATE_DIMS:
        raise ValueError(f"state dim {n} not in {STATE_DIMS}")
    for name in ("x", "dt", "B", "C"):
        if tensors[name].stride(2) != 1:
            raise ValueError(f"{name}: need unit stride on the last axis, got "
                             f"strides {tensors[name].stride()}")
    for name in ("A", "D", "h0"):
        if name in tensors and not tensors[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 < bt <= 65535:
        raise ValueError(f"batch {bt}: need 1..65535 rows")


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
               h0: torch.Tensor | None = None):
    """Shapes and result as ``mamba_scan_plain``; B and C may be strided
    along their batch and time axes (slices of one projection).  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return mamba_scan_plain(x, dt, A, B, C, D, h0)
    _check(x, dt, A, B, C, D, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, B, C, D, h0)):
        raise NotImplementedError(
            f"the scan kernel has no backward yet: {TRAINING_ITEM}")
    bt, s, din = x.shape
    n = A.shape[1]
    y = torch.empty((bt, s, din), dtype=x.dtype, device=x.device)
    h_final = torch.empty((bt, din, n), dtype=torch.float32, device=x.device)
    rc = _build.library().mamba_scan(
        DTYPE_CODES[x.dtype], n, x.data_ptr(), dt.data_ptr(), B.data_ptr(),
        C.data_ptr(), A.data_ptr(), D.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h_final.data_ptr(),
        bt, s, din, x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
        B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "mamba_scan")
    mamba_scan.launches += 1
    return y, h_final


mamba_scan.launches = 0
