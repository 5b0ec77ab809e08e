"""Decoder-only LM for the dense family: a port of the dense path of
``repro.models.transformer.LM``.

Parameters are a dict of tensors with the JAX tree's keys and its
stacked leading-``L`` shapes (``blocks/wq`` is (L, D, Hq·hd)), so a JAX
parameter tree converts key by key (``repro_torch.convert``).  The JAX
``lax.scan`` over layers is a Python loop over that leading axis, and
its ``jax.checkpoint`` per layer (and per loss chunk) is
``torch.utils.checkpoint``.  The decode cache keeps JAX's (L, B, T, Hkv,
hd) layout but, unlike the JAX functional update, is written in place.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from .config import ModelConfig
from .layers import apply_rope, blocked_attention, decode_attention, rms_norm, swiglu

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}

# families still to be ported, with the ROADMAP.md item that ports them
NOT_PORTED = {
    "moe": "Queue 1, 'the other families' (MoE)",
    "ssm": "Queue 1, 'SSM families'",
    "hybrid": "Queue 1, 'SSM families'",
    "encdec": "Queue 1, 'the other families' (encoder-decoder)",
    "vlm": "Queue 1, 'the other families' (VLM)",
}


class LM:
    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None):
        if cfg.family in NOT_PORTED:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: ROADMAP.md "
                f"{NOT_PORTED[cfg.family]}")
        if cfg.family != "dense":
            raise ValueError(cfg.family)
        if cfg.sharded_decode:
            raise NotImplementedError(
                "sharded_decode is not ported yet: ROADMAP.md Queue 1, "
                "'Sharding and meshes'")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pdt = DTYPES[cfg.param_dtype]
        self.cdt = DTYPES[cfg.compute_dtype]

    # ------------------------------------------------------------------ params

    def init(self, seed: int = 0) -> dict:
        """Random parameters with the JAX init's shapes and scales (normal
        0.02; ``wo`` 0.02/sqrt(2L); norms 1; biases 0), drawn in f32 from
        a ``torch.Generator`` on the model's device and cast to
        ``param_dtype``.  The draws differ from JAX's for the same seed."""
        c = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def normal(shape, scale=0.02):
            x = torch.randn(shape, generator=gen, device=self.device)
            return (x * scale).to(self.pdt)

        def ones(shape):
            return torch.ones(shape, dtype=self.pdt, device=self.device)

        def zeros(shape):
            return torch.zeros(shape, dtype=self.pdt, device=self.device)

        L, d, hd = c.n_layers, c.d_model, c.hd
        p: dict = {"emb": normal((c.padded_vocab, d)), "out_norm": ones((d,))}
        if not c.tie_embeddings:
            p["lm_head"] = normal((d, c.padded_vocab))
        blocks = {
            "ln1": ones((L, d)),
            "wq": normal((L, d, c.n_heads * hd)),
            "wk": normal((L, d, c.n_kv_heads * hd)),
            "wv": normal((L, d, c.n_kv_heads * hd)),
            "wo": normal((L, c.n_heads * hd, d),
                         scale=0.02 / math.sqrt(2 * max(L, 1))),
        }
        if c.qkv_bias:
            blocks["bq"] = zeros((L, c.n_heads * hd))
            blocks["bk"] = zeros((L, c.n_kv_heads * hd))
            blocks["bv"] = zeros((L, c.n_kv_heads * hd))
        blocks.update(ln2=ones((L, d)), wg=normal((L, d, c.d_ff)),
                      wu=normal((L, d, c.d_ff)), wd=normal((L, c.d_ff, d)))
        p["blocks"] = blocks
        return p

    @staticmethod
    def _layer(params: dict, i: int) -> dict:
        return {k: v[i] for k, v in params["blocks"].items()}

    # ------------------------------------------------------------------ attention pieces

    def _qkv(self, bp: dict, h: torch.Tensor, positions: torch.Tensor):
        c = self.cfg
        hd = c.hd
        b, s, _ = h.shape
        q = h @ bp["wq"]
        k = h @ bp["wk"]
        v = h @ bp["wv"]
        if "bq" in bp:
            q, k, v = q + bp["bq"], k + bp["bk"], v + bp["bv"]
        q = q.reshape(b, s, c.n_heads, hd)
        k = k.reshape(b, s, c.n_kv_heads, hd)
        v = v.reshape(b, s, c.n_kv_heads, hd)
        q = apply_rope(q, positions, c.rope_theta, c.rope_style)
        k = apply_rope(k, positions, c.rope_theta, c.rope_style)
        return q, k, v

    def _mlp(self, bp: dict, x: torch.Tensor) -> torch.Tensor:
        h = rms_norm(x, bp["ln2"], self.cfg.norm_eps)
        return x + swiglu(h, bp["wg"], bp["wu"], bp["wd"])

    def _block(self, bp: dict, x: torch.Tensor, positions: torch.Tensor):
        """One causal layer over a full sequence; returns (x, k, v)."""
        b, s, _ = x.shape
        h = rms_norm(x, bp["ln1"], self.cfg.norm_eps)
        q, k, v = self._qkv(bp, h, positions)
        o = blocked_attention(q, k, v, causal=True)
        x = x + o.reshape(b, s, -1) @ bp["wo"]
        return self._mlp(bp, x), k, v

    # ------------------------------------------------------------ forward (train / prefill-style)

    def _train_block(self, bp: dict, x: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
        return self._block(bp, x, positions)[0]

    def forward(self, params: dict, batch: dict,
                remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (final hidden states (B, S, D), aux loss scalar f32; 0
        for the dense family).  Differentiable; with ``remat`` each layer
        is checkpointed, so only its input is kept for the backward and
        the layer (its attention kernel included) runs again there."""
        c = self.cfg
        tokens = batch["tokens"]
        x = params["emb"][tokens].to(self.cdt)
        positions = torch.arange(tokens.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        # unbind, not indexing: its backward stacks the layers' gradients
        # in one pass instead of adding L zero-padded copies
        names = list(params["blocks"])
        per_layer = zip(*(params["blocks"][k].unbind(0) for k in names))
        for leaves in per_layer:
            bp = dict(zip(names, leaves))
            if remat:
                x = checkpoint(self._train_block, bp, x, positions,
                               use_reentrant=False)
            else:
                x = self._train_block(bp, x, positions)
        return rms_norm(x, params["out_norm"], c.norm_eps), aux

    # ------------------------------------------------------------------ loss

    def lm_head(self, params: dict) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["emb"].T
        return params["lm_head"]

    @staticmethod
    def _chunk_nll(xb: torch.Tensor, tb: torch.Tensor,
                   head: torch.Tensor) -> torch.Tensor:
        """Summed cross-entropy of one sequence chunk (B, chunk, D)."""
        logits = (xb @ head).float()
        gold = logits.gather(-1, tb[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - gold).sum()

    def loss(self, params: dict, batch: dict, remat: bool = True,
             loss_chunk: int = 512) -> torch.Tensor:
        """Causal LM cross-entropy over every position (the last label of
        a row is counted like any other), logits computed in sequence
        chunks, each checkpointed, so the (B, chunk, V) f32 logits are
        recomputed in the backward and the (B, S, V) tensor never exists."""
        x, aux = self.forward(params, batch, remat=remat)
        targets = batch["labels"].long()
        head = self.lm_head(params)
        b, s, _ = x.shape
        chunk = min(loss_chunk, s)
        if s % chunk:
            raise ValueError(f"sequence {s} is not a multiple of loss_chunk {chunk}")
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, s, chunk):
            tot = tot + checkpoint(self._chunk_nll, x[:, c0:c0 + chunk],
                                   targets[:, c0:c0 + chunk], head,
                                   use_reentrant=False)
        return tot / (b * s) + 0.01 * aux

    # ------------------------------------------------------------------ decode

    def init_cache(self, batch: int, max_len: int) -> dict:
        c = self.cfg
        kv = (c.n_layers, batch, max_len, c.n_kv_heads, c.hd)
        return {"len": torch.zeros((), dtype=torch.int32, device=self.device),
                "k": torch.zeros(kv, dtype=self.cdt, device=self.device),
                "v": torch.zeros(kv, dtype=self.cdt, device=self.device)}

    def _attn_decode(self, bp: dict, x1: torch.Tensor, kc: torch.Tensor,
                     vc: torch.Tensor, pos: torch.Tensor,
                     n_live: torch.Tensor) -> torch.Tensor:
        """One-token self-attention against one layer's cache.  x1: (B, 1,
        D); kc/vc: (B, T, Hkv, hd), written in place at position ``pos``
        ((1,) int64), then attended up to ``n_live`` = pos + 1 (int32).
        Both stay on the device: no host sync."""
        c = self.cfg
        b = x1.shape[0]
        h = rms_norm(x1, bp["ln1"], c.norm_eps)
        q, k, v = self._qkv(bp, h, pos)
        kc.index_copy_(1, pos, k.to(kc.dtype))
        vc.index_copy_(1, pos, v.to(vc.dtype))
        o = decode_attention(q, kc, vc, n_live)
        return x1 + o.reshape(b, 1, -1) @ bp["wo"]

    @torch.no_grad()
    def decode_step(self, params: dict, cache: dict,
                    token: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """token: (B,) int -> (cache, logits (B, V) f32).  The cache's k/v
        are updated in place; ``len`` is advanced by one."""
        c = self.cfg
        length = cache["len"]
        pos, n_live = length.reshape(1).long(), length + 1
        x = params["emb"][token][:, None].to(self.cdt)       # (B, 1, D)
        for i in range(c.n_layers):
            bp = self._layer(params, i)
            x = self._attn_decode(bp, x, cache["k"][i], cache["v"][i], pos, n_live)
            x = self._mlp(bp, x)
        x = rms_norm(x, params["out_norm"], c.norm_eps)
        logits = (x[:, 0] @ self.lm_head(params)).float()
        cache["len"] = n_live
        return cache, logits

    # ------------------------------------------------------------------ prefill

    @torch.no_grad()
    def prefill(self, params: dict, batch: dict,
                max_len: int) -> tuple[dict, torch.Tensor]:
        """Run the full prompt, fill a fresh decode cache layer by layer,
        return (cache, last-position logits (B, V) f32)."""
        c = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = self.init_cache(b, max_len)
        positions = torch.arange(s, device=self.device)
        x = params["emb"][tokens].to(self.cdt)
        for i in range(c.n_layers):
            x, k, v = self._block(self._layer(params, i), x, positions)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        x = rms_norm(x, params["out_norm"], c.norm_eps)
        logits = (x[:, -1] @ self.lm_head(params)).float()
        cache["len"].fill_(s)
        return cache, logits
