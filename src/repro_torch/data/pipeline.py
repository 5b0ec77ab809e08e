"""Deterministic, checkpointable synthetic token pipeline: the port's
own copy of ``repro.data.pipeline`` (numpy only).

Batches are a pure function of (seed, step, shard): counter-based PCG64
streams, the same as the JAX package's, so both packages read the same
batches and a restart resumes mid-stream with no drift.  The enc-dec
and VLM stubs are generated the same way.
"""

from __future__ import annotations

import numpy as np

from repro_torch.models.config import ModelConfig


class TokenDataset:
    def __init__(self, cfg: ModelConfig, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def _rng(self, step: int, stream: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.PCG64([self.seed, step, stream]))

    def get_batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """Batch (or one data-parallel shard of it) for ``step``, as numpy."""
        if self.global_batch % n_shards:
            raise ValueError(f"global batch {self.global_batch} does not split "
                             f"into {n_shards} shards")
        b = self.global_batch // n_shards
        rng = self._rng(step, shard)
        # markov-ish stream so the loss is learnable (not pure noise)
        base = rng.integers(0, self.cfg.vocab, size=(b, 1), dtype=np.int32)
        drift = rng.integers(0, 17, size=(b, self.seq_len), dtype=np.int32)
        toks = (base + np.cumsum(drift, axis=1)) % self.cfg.vocab
        tokens = toks.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = 0
        out = {"tokens": tokens, "labels": labels}
        if self.cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (b, self.cfg.enc_seq, self.cfg.d_model)).astype(np.float32) * 0.1
        if self.cfg.family == "vlm":
            out["img_embeds"] = rng.standard_normal(
                (b, self.cfg.img_tokens, self.cfg.d_model)).astype(np.float32) * 0.1
        return out

    def state(self, step: int) -> dict:
        return {"seed": self.seed, "step": step}

    @staticmethod
    def restore(cfg: ModelConfig, seq_len: int, global_batch: int,
                state: dict) -> tuple["TokenDataset", int]:
        return (TokenDataset(cfg, seq_len, global_batch, state["seed"]),
                state["step"])
