"""Single-token decode attention: the CUDA kernel's wrapper and its plain
version.

``decode_attention`` launches ``csrc/decode_attention.cu`` for CUDA
tensors and takes ``decode_attention_plain`` for CPU tensors; there is no
other path.  The plain version mirrors ``repro.models.layers
.decode_attention`` (f32 logits and softmax, probabilities cast to the
cache's dtype before the PV product).
"""

from __future__ import annotations

import functools
import math

import torch

from . import _build
from .flash_attention import DTYPE_CODES, HEAD_DIMS, check_rows

MAX_GROUP = 16     # query heads per KV head that one block's state holds
KEY_TILE = 32      # keys per tile of the kernel
MAX_SPLITS = 16    # splits of one (KV head, batch row): one cluster, H100's largest


def decode_splits(b: int, t: int, hkv: int, sm_count: int) -> int:
    """Blocks per (KV head, batch row): the most that keep the grid
    (Hkv, B, splits) within one block per SM, at most one per tile of 32
    cache rows and at most 16.  A function of the shapes alone, so every
    call at a shape (and a CUDA graph of it) launches the same grid."""
    tiles = -(-t // KEY_TILE)
    return max(1, min(tiles, MAX_SPLITS, sm_count // (b * hkv)))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           length: torch.Tensor | int) -> torch.Tensor:
    """q: (B, 1, Hq, D); caches: (B, T, Hkv, D); ``length``: a scalar or
    (B,) -- the valid cache prefix of each row.  Returns (B, 1, Hq, D)."""
    b, _, hq, d = q.shape
    t = k_cache.shape[1]
    k = k_cache.repeat_interleave(hq // k_cache.shape[2], dim=2)
    v = v_cache.repeat_interleave(hq // v_cache.shape[2], dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.float() / math.sqrt(d), k.float())
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1, 1)
    mask = torch.arange(t, device=q.device)[None, None, None, :] < length
    logits = torch.where(mask, logits, -torch.inf)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: torch.Tensor | int) -> torch.Tensor:
    """q: (B, 1, Hq, D); caches: (B, T, Hkv, D) read in place; ``length``:
    int32 tensor of shape () or (B,) on the caches' device (for CPU
    tensors also a Python int).  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, length)
    b, one, hq, d = q.shape
    if not (q.is_cuda and k_cache.device == q.device and v_cache.device == q.device):
        raise ValueError("q and the caches must lie on one CUDA device")
    if (q.dtype not in DTYPE_CODES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError(f"dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}: "
                        "need one of float32, bfloat16 for all three")
    if (one != 1 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape
            or k_cache.shape[0] != b or k_cache.shape[3] != d):
        raise ValueError(f"shapes q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}: need "
                         "(B,1,Hq,D) and (B,T,Hkv,D)")
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"{hq} query heads over {hkv} KV heads: need a "
                         f"whole group of at most {MAX_GROUP}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        check_rows(name, x)
    if not (isinstance(length, torch.Tensor) and length.device == q.device
            and length.dtype == torch.int32 and length.shape in ((), (b,))
            and length.is_contiguous()):
        raise ValueError("length must be an int32 tensor of shape () or "
                         f"({b},) on {q.device}")
    o = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    n_split = decode_splits(b, t, hkv, _sm_count(q.device.index))
    rc = _build.library().decode_attention(
        DTYPE_CODES[q.dtype], d, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), length.data_ptr(), int(length.dim() == 1), o.data_ptr(),
        n_split, b, t, hq, hkv, q.stride(0), q.stride(2), *k_cache.stride()[:3],
        *v_cache.stride()[:3], o.stride(0), o.stride(2), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "decode_attention")
    _build.count_launch(decode_attention)
    return o


decode_attention.launches = 0
