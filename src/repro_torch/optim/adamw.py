"""AdamW over trees of tensors: a port of ``repro.optim.adamw``.

Not ``torch.optim.AdamW``: it works on the same trees as the JAX
package (dicts of tensors, ``OptState`` with the fields ``step``, ``m``
and ``v``, whose names the checkpoint keys carry), clips by the global
norm first, evaluates the learning rate and the bias corrections at
``step + 1``, decays every leaf, and does each update in f32 before
casting back.  The schedule is computed on the device in f32, so a step
never waits on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten_like

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def clip_by_global_norm(grads: Any, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping as an f32 scalar)."""
    gn = torch.sqrt(sum(g.float().square().sum() for g in leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    down to 0 at ``total``; ``lr(step)`` takes an int or a tensor and
    returns an f32 tensor on the step's device."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # "bfloat16" for the giant configs

    def init(self, params: Any) -> OptState:
        mdt = _MOMENT_DTYPES[self.moment_dtype]
        device = leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
        return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                        m=tree_map(zeros, params), v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads: Any, state: OptState, params: Any):
        """-> (new params, new state, global grad norm before clipping)."""
        mdt = _MOMENT_DTYPES[self.moment_dtype]
        grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        step = state.step + 1
        stepf = step.to(torch.float32)
        lr_t = cosine_schedule(self.lr, self.warmup_steps, self.total_steps)(step)
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, device=step.device), stepf)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, device=step.device), stepf)

        def upd(p, g, m, v):
            g32 = g.float()
            m_new = self.b1 * m.float() + (1 - self.b1) * g32
            v_new = self.b2 * v.float() + (1 - self.b2) * g32 * g32
            delta = (m_new / c1) / (torch.sqrt(v_new / c2) + self.eps) \
                + self.weight_decay * p.float()
            p_new = p.float() - lr_t * delta
            return p_new.to(p.dtype), m_new.to(mdt), v_new.to(mdt)

        out = [upd(*leaf) for leaf in zip(leaves(params), leaves(grads), leaves(state.m),
                                          leaves(state.v), strict=True)]
        new_p, new_m, new_v = (unflatten_like(params, [o[i] for o in out]) for i in range(3))
        return new_p, OptState(step=step, m=new_m, v=new_v), gnorm
