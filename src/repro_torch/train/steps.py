"""Training step: loss, gradients and the AdamW update; a port of
``repro.train.steps.make_train_step``.

Gradients come from ``torch.autograd.grad`` on detached copies of the
parameters that require grad, so the caller's tensors never carry
autograd state.  With ``microbatches > 1`` the batch is split along its
first axis and the gradients are summed in f32, then divided by
``microbatches``, as the JAX step does.  No ``torch.compile``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.transformer import LM
from repro_torch.optim import AdamW, OptState
from repro_torch.tree import leaves, unflatten_like


def _value_and_grad(lm: LM, params: dict, batch: dict, remat: bool):
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = lm.loss(unflatten_like(params, flat), batch, remat=remat)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten_like(params, list(grads))


def make_train_step(lm: LM, opt: AdamW, microbatches: int = 1,
                    remat: bool = True) -> Callable:
    """-> ``train_step(params, opt_state, batch)`` returning
    ``(params, opt_state, {"loss", "gnorm"})``, both metrics f32 scalars
    on the device."""
    if microbatches == 1:
        def train_step(params: dict, opt_state: OptState, batch: dict):
            loss, grads = _value_and_grad(lm, params, batch, remat)
            params, opt_state, gnorm = opt.update(grads, opt_state, params)
            return params, opt_state, {"loss": loss, "gnorm": gnorm}
        return train_step

    def train_step(params: dict, opt_state: OptState, batch: dict):
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} is not a multiple of {microbatches} microbatches")
        micro = [{k: v[i * (b // microbatches):(i + 1) * (b // microbatches)]
                  for k, v in batch.items()} for i in range(microbatches)]
        tot_loss = torch.zeros((), dtype=torch.float32, device=lm.device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves(params)]
        for mb in micro:
            loss, grads = _value_and_grad(lm, params, mb, remat)
            tot_loss = tot_loss + loss
            acc = [a + g for a, g in zip(acc, leaves(grads), strict=True)]
        grads = unflatten_like(params, [(a / microbatches).float() for a in acc])
        params, opt_state, gnorm = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": tot_loss / microbatches, "gnorm": gnorm}
    return train_step
