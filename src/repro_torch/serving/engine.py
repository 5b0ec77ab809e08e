"""Batched serving engine: prefill + continuous-batching decode.

A port of ``repro.serving.engine``: ``max_batch`` fixed decode slots
filled in rounds (a round is admitted when every slot is free), each
request prefilled on its own and spliced into its slot of the shared
cache, one scalar cache length shared by the slots, greedy ``argmax``.
On the GPU the prefill and decode attention run the port's CUDA kernels.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 8
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: dict | None = None, *,
                 max_batch: int = 4, max_len: int = 64, prompt_len: int = 8,
                 seed: int = 0, device: str | torch.device | None = None):
        """``params``: the port's parameters, already on ``device`` (see
        ``repro_torch.convert``); when None they are drawn from ``seed``."""
        self.cfg = cfg
        self.lm = LM(cfg, device)
        self.device = self.lm.device
        self.params = params if params is not None else self.lm.init(seed)
        self.max_batch = max_batch
        self.max_len = max_len
        # uniform prompt length keeps decode positions shared across
        # slots (the shared cache carries one scalar length); prompts
        # are right-padded/truncated to this length at submission
        self.prompt_len = prompt_len
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * max_batch
        self.slot_len = np.zeros(max_batch, np.int32)
        self.cache = self.lm.init_cache(max_batch, max_len)
        self._stats = {"prefills": 0, "decode_steps": 0, "completed": 0}

    def submit(self, req: Request) -> None:
        p = list(req.prompt)[:self.prompt_len]
        p = p + [0] * (self.prompt_len - len(p))
        req.prompt = p
        self.queue.append(req)

    def _admit(self) -> None:
        """Admit a new batch round when all slots are free (rolling
        batches: every active slot shares one decode position, so the
        scalar cache length stays exact)."""
        if any(s is not None for s in self.slots):
            return
        self.cache = self.lm.init_cache(self.max_batch, self.max_len)
        self.slot_len[:] = 0
        for slot in range(self.max_batch):
            if not self.queue:
                continue
            req = self.queue.popleft()
            toks = torch.tensor([req.prompt], dtype=torch.int64, device=self.device)
            cache1, logits = self.lm.prefill(self.params, {"tokens": toks},
                                             max_len=self.max_len)
            self._stats["prefills"] += 1
            self._splice(cache1, slot)
            self.slot_len[slot] = len(req.prompt)
            req.out_tokens.append(int(torch.argmax(logits[0])))
            self.slots[slot] = req

    def _splice(self, cache1: dict, slot: int) -> None:
        """Copy a single-stream cache into ``slot`` of the batch cache, in
        place, along the first axis where the batch cache has
        ``max_batch`` rows and the single one has 1."""
        for key, dst in self.cache.items():
            if key == "len" or dst.dim() == 0:
                continue
            src = cache1[key]
            for axis in range(dst.dim()):
                if dst.shape[axis] == self.max_batch and src.shape[axis] == 1:
                    dst.narrow(axis, slot, 1).copy_(src)
                    break

    def _step_decode(self) -> None:
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return
        tokens = np.zeros(self.max_batch, np.int64)
        for i in active:
            tokens[i] = self.slots[i].out_tokens[-1]
        # the shared cache["len"] is scalar: decode at the longest active
        # slot; a shorter slot's cache past its own length is zero-KV
        self.cache["len"] = torch.tensor(int(self.slot_len[active].max()),
                                         dtype=torch.int32, device=self.device)
        self.cache, logits = self.lm.decode_step(
            self.params, self.cache, torch.from_numpy(tokens).to(self.device))
        self._stats["decode_steps"] += 1
        nxt = torch.argmax(logits, dim=-1).tolist()
        for i in active:
            self.slot_len[i] += 1
            req = self.slots[i]
            req.out_tokens.append(nxt[i])
            if (len(req.out_tokens) >= req.max_new_tokens
                    or self.slot_len[i] + 1 >= self.max_len):
                req.done = True
                self._stats["completed"] += 1
                self.slots[i] = None

    def run(self, max_steps: int = 1000) -> dict:
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self._admit()
            self._step_decode()
            steps += 1
        return dict(self._stats)
