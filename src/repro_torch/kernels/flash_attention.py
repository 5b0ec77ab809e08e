"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors
and takes ``flash_attention_plain`` for CPU tensors; there is no other
path.  The plain version mirrors ``repro.models.layers._flash_core``
(chunked online softmax, bf16 rounded where the JAX function rounds it),
which is also what the CPU tests hold against the JAX package.
"""

from __future__ import annotations

import math

import torch

from . import _build

NEG_BIG = -1e30
CHUNK = 512            # KV chunk of the jnp reference (layers.blocked_attention)
HEAD_DIMS = (16, 32, 48, 64, 80, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, q_offset: int = 0,
                          kv_len: int | None = None):
    """q: (B, S, Hq, D); k, v: (B, T, Hkv, D).  Returns (o (B, S, Hq, D)
    in q's dtype, lse (B, Hq, S) f32).  Mask: key < kv_len and, when
    causal, key <= q_offset + q_pos (top-left aligned)."""
    b, s, hq, d = q.shape
    t = k.shape[1]
    kv_len = t if kv_len is None else kv_len
    k = k.repeat_interleave(hq // k.shape[2], dim=2)
    v = v.repeat_interleave(hq // v.shape[2], dim=2)
    qf = (q.float() * (1.0 / math.sqrt(d))).to(q.dtype).float()
    q_pos = q_offset + torch.arange(s, device=q.device)
    m = torch.full((b, hq, s), NEG_BIG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, s, d), dtype=torch.float32, device=q.device)
    chunk = min(CHUNK, t)
    for c0 in range(0, t, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kv_pos = c0 + torch.arange(kb.shape[1], device=q.device)
        logits = torch.einsum("bshd,bthd->bhst", qf, kb.float())
        mask = (kv_pos[None, :] < kv_len) & torch.ones(
            (s, 1), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        logits = torch.where(mask, logits, NEG_BIG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.where(mask, torch.exp(logits - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhst,bthd->bhsd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    l_safe = torch.clamp(l, min=1e-37)
    out = acc / l_safe[..., None]
    return out.transpose(1, 2).to(q.dtype), m + torch.log(l_safe)


def _rows_readable(x: torch.Tensor) -> bool:
    """The kernels copy rows 16 bytes at a time along D: unit stride on
    D, and every row start aligned to 16 bytes."""
    per = 16 // x.element_size()
    return x.stride(3) == 1 and not any(st % per for st in x.stride()[:3]) \
        and not x.data_ptr() % 16


def check_rows(name: str, x: torch.Tensor) -> None:
    if not _rows_readable(x):
        raise ValueError(f"{name}: need unit stride on D and rows aligned to 16 "
                         "bytes (4-aligned in float32, 8-aligned in bfloat16), "
                         f"got strides {x.stride()}")


def readable_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` when the kernels can read it in place, else a fresh contiguous
    copy (a new allocation starts aligned)."""
    return x if _rows_readable(x) else x.clone(memory_format=torch.contiguous_format)


def _check(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of "
                        "float32, bfloat16 for all three")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}: need (B,S,Hq,D) and (B,T,Hkv,D)")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_rows(name, x)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, q_offset: int = 0, kv_len: int | None = None,
                    return_lse: bool = False):
    """q: (B, S, Hq, D); k, v: (B, T, Hkv, D) -> o (B, S, Hq, D)
    [, lse (B, Hq, S) f32].  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        o, lse = flash_attention_plain(q, k, v, causal, q_offset, kv_len)
        return (o, lse) if return_lse else o
    _check(q, k, v)
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    kv_len = t if kv_len is None else kv_len
    if q_offset < 0 or kv_len < 0:
        raise ValueError(f"q_offset {q_offset} and kv_len {kv_len} must be >= 0")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    rc = _build.library().flash_attention_fwd(
        DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), None if lse is None else lse.data_ptr(),
        b, s, t, hq, hkv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], int(causal), q_offset, kv_len, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_fwd")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0
