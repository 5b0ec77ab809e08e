"""Flash-attention backward: the CUDA kernel's wrapper and its plain version.

``flash_attention_bwd`` launches ``csrc/flash_attention_bwd.cu`` for CUDA
tensors and takes ``flash_attention_bwd_plain`` for CPU tensors; there is
no other path.  The plain version mirrors ``repro.models.layers._flash_bwd``
(KV chunks of ``min(512, T)``, everything in f32), which is also what the
CPU tests hold against the JAX package.  Both return dk and dv in Hkv
heads, summed over each KV head's group of query heads in f32 and
rounded to the input dtype once.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .flash_attention import CHUNK, DTYPE_CODES, _check, check_rows


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                              causal: bool, q_offset: int = 0):
    """q, o, do: (B, S, Hq, D); k, v: (B, T, Hkv, D); lse: (B, Hq, S) f32.
    Returns (dq like q, dk, dv like k) in the inputs' dtype."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    qf = q.float()
    dof = do.float().transpose(1, 2)                          # (B, Hq, S, D)
    delta = (dof * o.float().transpose(1, 2)).sum(dim=-1)     # (B, Hq, S)
    q_pos = q_offset + torch.arange(s, device=q.device)
    dq = torch.zeros((b, s, hq, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    chunk = min(CHUNK, t)
    for c0 in range(0, t, chunk):
        kb, vb = kf[:, c0:c0 + chunk], vf[:, c0:c0 + chunk]
        kv_pos = c0 + torch.arange(kb.shape[1], device=q.device)
        logits = scale * torch.einsum("bshd,bthd->bhst", qf, kb)
        p = torch.exp(logits - lse[..., None])
        if causal:
            p = torch.where(kv_pos[None, :] <= q_pos[:, None], p, 0.0)
        dvs.append(torch.einsum("bhst,bhsd->bthd", p, dof))
        dp = torch.einsum("bhsd,bthd->bhst", dof, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhst,bthd->bshd", ds, kb)
        dks.append(torch.einsum("bhst,bshd->bthd", ds, qf))
    dk = torch.cat(dks, dim=1).reshape(b, t, hkv, rep, d).sum(dim=3)
    dv = torch.cat(dvs, dim=1).reshape(b, t, hkv, rep, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        causal: bool, q_offset: int = 0):
    """q, o, do: (B, S, Hq, D); k, v: (B, T, Hkv, D); lse: (B, Hq, S) f32
    from the forward -> (dq, dk, dv), dk and dv in Hkv heads.  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal, q_offset)
    _check(q, k, v)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} must match q "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
        check_rows(name, x)
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if lse.shape != (b, hq, s) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: need contiguous "
                         f"float32 ({b}, {hq}, {s}) on {q.device}")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} must be >= 0")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    # scratch: delta = rowsum(do·o), and each query head's dk and dv in f32
    # before the group sum (not needed by bf16 at a group of 1)
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    dkv_part = (torch.empty((2, b, t, hq, d), dtype=torch.float32, device=q.device)
                if q.dtype == torch.float32 or hq != hkv else None)
    rc = _build.library().flash_attention_bwd(
        DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if dkv_part is None else dkv_part.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, t, hq, hkv,
        *(st for x in (q, k, v, o, do, dq, dk, dv) for st in x.stride()[:3]),
        int(causal), q_offset, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
