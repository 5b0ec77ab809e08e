"""Model building blocks: the dense and SSM subset of
``repro.models.layers``.

Elementwise and normalisation code is plain PyTorch; the attention
functions and the selective scan go through the kernels' wrappers, which
launch the CUDA kernels for tensors on the GPU and take their plain
versions for tensors on the CPU.  ``blocked_attention`` is differentiable
through ``FlashAttention``, whose backward is the flash-attention
backward kernel; the scan kernel is forward only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import decode_attention as _decode_kernel
from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel
from repro_torch.kernels.flash_attention import readable_rows
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd as _flash_bwd_kernel
from repro_torch.kernels.mamba_scan import softplus
from repro_torch.kernels.mamba_scan import mamba_scan as _scan_kernel


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


# -- RoPE ------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, style: str) -> np.ndarray:
    rot = head_dim if style == "full" else head_dim // 2
    return 1.0 / theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot)


@functools.lru_cache(maxsize=32)
def _freqs_on(head_dim: int, theta: float, style: str,
              device: torch.device) -> torch.Tensor:
    """``rope_freqs`` as a tensor on ``device``, copied there once rather
    than at every layer of every step."""
    return torch.from_numpy(rope_freqs(head_dim, theta, style)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               style: str = "full") -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Rotates
    interleaved pairs (x[..., 0::2], x[..., 1::2]); ``style="half"``
    rotates only the first half of D."""
    d = x.shape[-1]
    rot = d if style == "full" else d // 2
    freqs = _freqs_on(d, theta, style, x.device)
    ang = positions[..., None].float() * freqs                 # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape).to(x.dtype)
    if rot == d:
        return rotated
    return torch.cat([rotated, x[..., rot:]], dim=-1)


# -- attention ---------------------------------------------------------------------


def _expand_kv(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """(B, T, Hkv, D) -> (B, T, Hq, D), each KV head repeated in place."""
    hkv = k.shape[2]
    if hkv == n_q_heads:
        return k
    return k.repeat_interleave(n_q_heads // hkv, dim=2)


class FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward, the counterpart of the
    custom VJP of ``repro.models.layers._flash_attention_xla``: the
    forward saves only (q, k, v, o, lse); the backward recomputes the
    probabilities tile by tile in the backward kernel.  On the CPU both
    directions take the kernels' plain versions; nothing is
    differentiated through the plain forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int):
        o, lse = _flash_kernel(q, k, v, causal=causal, q_offset=q_offset,
                               return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand over a strided or misaligned gradient; the
        # kernel reads unit-stride rows that start 16-byte aligned
        dq, dk, dv = _flash_bwd_kernel(q, k, v, o, readable_rows(do), lse,
                                       ctx.causal, ctx.q_offset)
        return dq, dk, dv, None, None


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Flash attention.  q: (B, S, Hq, D); k, v: (B, T, Hkv, D); GQA
    through the kernel's head mapping, no KV repeat in memory.  When a
    gradient is wanted it goes through ``FlashAttention``; otherwise
    (prefill) the forward kernel runs alone, without lse."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, q_offset)
    return _flash_kernel(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor | int) -> torch.Tensor:
    """Single-position GQA attention against a KV cache.  q: (B, 1, Hq, D);
    caches: (B, T, Hkv, D); ``length`` (scalar or (B,)) masks the valid
    prefix."""
    return _decode_kernel(q, k_cache, v_cache, length)


# -- MLPs ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ wg) * (x @ wu)
    return h @ wd


# -- causal depthwise conv (mamba) -------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Depthwise causal conv.  x: (B, S, C); w: (K, C).  The sum of K
    shifted products in x's dtype, as the JAX function takes it.

    Returns (y, new_state): ``state`` carries the trailing K-1 inputs so
    decode can stream one token at a time.
    """
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, xp.shape[1] - (k - 1):]
    return y, new_state


# -- selective scan (mamba) --------------------------------------------------------


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   h0: torch.Tensor | None = None):
    """Selective state-space scan (Mamba recurrence).

    x, dt: (Bt, S, Din);  A: (Din, N);  B, C: (Bt, S, N);  D: (Din,)
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t;  y_t = C_t . h_t + D * x_t
    (dt taken through softplus first).  Returns (y in x's dtype,
    h_final (Bt, Din, N) f32).

    The scan kernel walks all S steps with the state in registers, so the
    JAX function's ``chunk`` (its memory knob) has no counterpart, and the
    sequence is never padded: ``h_final`` is the state after step S-1 for
    every S.  Only the f32 scan is ported (``LM`` refuses another
    ``ssm_scan_dtype``).
    """
    return _scan_kernel(x, dt, A, B, C, D, h0)


def selective_scan_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                        h: torch.Tensor):
    """Single decode step.  x, dt: (Bt, Din); B, C: (Bt, N); h: (Bt, Din, N)
    f32.  Returns (y in x's dtype, h_new f32)."""
    dt = softplus(dt.float())
    decay = torch.exp(dt[..., None] * A.float())
    h_new = decay * h + (dt * x.float())[..., None] * B.float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h_new, C.float()) + x.float() * D
    return y.to(x.dtype), h_new
