"""Decoder-only LMs of the dense, SSM and hybrid families: a port of
those paths of ``repro.models.transformer.LM``.

Parameters are a dict of tensors with the JAX tree's keys and its
stacked leading-``L`` shapes (``blocks/wq`` is (L, D, Hq·hd)), so a JAX
parameter tree converts key by key (``repro_torch.convert``).  The JAX
``lax.scan`` over layers is a Python loop over that leading axis, and
its ``jax.checkpoint`` per layer (and per loss chunk) is
``torch.utils.checkpoint``; the hybrid's ``lax.cond`` on the layer index
is a Python ``if``.  The decode cache keeps JAX's layouts ((L, B, T, Hkv,
hd) K/V; (L, B, Din, N) f32 SSM state and (L, B, K-1, Din) conv window;
the hybrid's K/V per application of its shared block) but, unlike the JAX
functional update, is written in place.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels.mamba_scan import TRAINING_ITEM

from .config import ModelConfig
from .layers import (
    apply_rope,
    blocked_attention,
    causal_conv1d,
    decode_attention,
    rms_norm,
    selective_scan,
    selective_scan_step,
    swiglu,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}

# families still to be ported, with the ROADMAP.md item that ports them
NOT_PORTED = {
    "moe": "Queue 1, 'the other families' (MoE)",
    "encdec": "Queue 1, 'the other families' (encoder-decoder)",
    "vlm": "Queue 1, 'the other families' (VLM)",
}
SSM_FAMILIES = ("ssm", "hybrid")


class LM:
    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None):
        if cfg.family in NOT_PORTED:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: ROADMAP.md "
                f"{NOT_PORTED[cfg.family]}")
        if cfg.family != "dense" and cfg.family not in SSM_FAMILIES:
            raise ValueError(cfg.family)
        if cfg.family in SSM_FAMILIES and cfg.ssm_scan_dtype != "float32":
            raise NotImplementedError(
                f"ssm_scan_dtype={cfg.ssm_scan_dtype!r} is not ported yet: "
                f"{TRAINING_ITEM}")
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
        """Random parameters with the JAX init's shapes, dtypes and scales
        (normal 0.02; ``wo`` 0.02/sqrt(2L); conv and dt_proj 0.1; norms 1;
        biases 0; ``A_log`` = log(1..N) and ``D`` = 1 in f32), drawn in f32
        from a ``torch.Generator`` on the model's device and cast to
        ``param_dtype``.  The draws differ from JAX's for the same seed."""
        c = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)

        def normal(shape, scale=0.02):
            x = torch.randn(shape, generator=gen, device=self.device)
            return x.mul_(scale).to(self.pdt)      # in place: one f32 copy at a time

        def ones(shape):
            return torch.ones(shape, dtype=self.pdt, device=self.device)

        def zeros(shape):
            return torch.zeros(shape, dtype=self.pdt, device=self.device)

        L, d = c.n_layers, c.d_model
        p: dict = {"emb": normal((c.padded_vocab, d)), "out_norm": ones((d,))}
        if not c.tie_embeddings:
            p["lm_head"] = normal((d, c.padded_vocab))
        if c.family == "dense":
            p["blocks"] = self._dense_params(normal, ones, zeros, (L,))
            return p
        s = c.ssm
        din, n = s.expand * d, s.state_dim
        dt_rank = max(1, math.ceil(d / 16))
        a_log = torch.from_numpy(np.log(np.arange(1, n + 1, dtype=np.float32)))
        p["blocks"] = {
            "ln": ones((L, d)),
            "in_proj": normal((L, d, 2 * din)),
            "conv_w": normal((L, s.conv_dim, din), scale=0.1),
            "x_proj": normal((L, din, dt_rank + 2 * n)),
            "dt_proj": normal((L, dt_rank, din), scale=0.1),
            "dt_bias": zeros((L, din)),
            "A_log": a_log.to(self.device).expand(L, din, n).contiguous(),
            "D": torch.ones((L, din), dtype=torch.float32, device=self.device),
            "out_proj": normal((L, din, d)),
        }
        if c.family == "hybrid":
            p["shared_attn"] = self._dense_params(normal, ones, zeros, ())
        return p

    def _dense_params(self, normal, ones, zeros, lead: tuple[int, ...]) -> dict:
        """One attention + SwiGLU layer's leaves, stacked over ``lead``:
        (L,) for the dense stack, () for the hybrid's shared block, whose
        ``wo`` is scaled by the stack's depth as in the JAX init."""
        c = self.cfg
        d, hd = c.d_model, c.hd
        p = {
            "ln1": ones(lead + (d,)),
            "wq": normal(lead + (d, c.n_heads * hd)),
            "wk": normal(lead + (d, c.n_kv_heads * hd)),
            "wv": normal(lead + (d, c.n_kv_heads * hd)),
            "wo": normal(lead + (c.n_heads * hd, d),
                         scale=0.02 / math.sqrt(2 * max(c.n_layers, 1))),
        }
        if c.qkv_bias:
            p["bq"] = zeros(lead + (c.n_heads * hd,))
            p["bk"] = zeros(lead + (c.n_kv_heads * hd,))
            p["bv"] = zeros(lead + (c.n_kv_heads * hd,))
        p.update(ln2=ones(lead + (d,)), wg=normal(lead + (d, c.d_ff)),
                 wu=normal(lead + (d, c.d_ff)), wd=normal(lead + (c.d_ff, d)))
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

    def _shared_after(self, i: int) -> bool:
        """Whether the hybrid's shared block runs after SSM layer ``i``."""
        c = self.cfg
        return c.family == "hybrid" and (i + 1) % c.shared_attn_every == 0

    # ------------------------------------------------------------------ SSM pieces

    def _ssm_in(self, bp: dict, x: torch.Tensor, conv0: torch.Tensor | None):
        """The Mamba block up to the scan: (xi, dt, A, B, C, z, conv_fin),
        rounded in the compute dtype where the JAX block rounds them."""
        c = self.cfg
        n, din = c.ssm.state_dim, c.ssm.expand * c.d_model
        dt_rank = bp["dt_proj"].shape[-2]
        h = rms_norm(x, bp["ln"], c.norm_eps)
        xz = h @ bp["in_proj"]
        xi, z = xz[..., :din], xz[..., din:]
        xi, conv_fin = causal_conv1d(xi, bp["conv_w"], conv0)
        xi = F.silu(xi)
        proj = xi @ bp["x_proj"]
        dt = proj[..., :dt_rank] @ bp["dt_proj"] + bp["dt_bias"]
        B = proj[..., dt_rank:dt_rank + n]
        C = proj[..., dt_rank + n:]
        A = -torch.exp(bp["A_log"])
        return xi, dt, A, B, C, z, conv_fin

    def _ssm_block(self, bp: dict, x: torch.Tensor):
        """Mamba block over a full sequence from a zero state.  Returns
        (x, h_fin (B, Din, N) f32, conv_fin (B, K-1, Din))."""
        xi, dt, A, B, C, z, conv_fin = self._ssm_in(bp, x, None)
        y, h_fin = selective_scan(xi, dt, A, B, C, bp["D"])
        return x + (y * F.silu(z)) @ bp["out_proj"], h_fin, conv_fin

    def _ssm_decode(self, bp: dict, x1: torch.Tensor, h: torch.Tensor,
                    conv: torch.Tensor) -> torch.Tensor:
        """One-token Mamba block.  x1: (B, 1, D); ``h`` (B, Din, N) f32 and
        ``conv`` (B, K-1, Din), one layer's cache, are updated in place."""
        xi, dt, A, B, C, z, conv_new = self._ssm_in(bp, x1, conv)
        y, h_new = selective_scan_step(xi[:, 0], dt[:, 0], A, B[:, 0], C[:, 0],
                                       bp["D"], h)
        h.copy_(h_new)
        conv.copy_(conv_new)
        return x1 + (y[:, None] * F.silu(z)) @ bp["out_proj"]

    # ------------------------------------------------------------ forward (train / prefill-style)

    def forward(self, params: dict, batch: dict,
                remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (final hidden states (B, S, D), aux loss scalar f32; 0
        for these families).  Differentiable on the CPU, and on the card
        for the dense family (the scan kernel has no backward yet); with
        ``remat`` each layer is checkpointed, so only its input is kept
        for the backward and the layer (its kernels included) runs again
        there."""
        c = self.cfg
        tokens = batch["tokens"]
        x = params["emb"][tokens].to(self.cdt)
        positions = torch.arange(tokens.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        # unbind, not indexing: its backward stacks the layers' gradients
        # in one pass instead of adding L zero-padded copies
        names = list(params["blocks"])
        per_layer = zip(*(params["blocks"][k].unbind(0) for k in names))

        def attn_layer(bp, x):
            return self._block(bp, x, positions)[0]

        def ssm_layer(bp, x):
            return self._ssm_block(bp, x)[0]

        def layer(fn, bp, x):
            if remat:
                return checkpoint(fn, bp, x, use_reentrant=False)
            return fn(bp, x)

        # the stack's layers are attention + MLP for the dense family and
        # Mamba blocks otherwise; the hybrid's shared block is attention
        stack_layer = attn_layer if c.family == "dense" else ssm_layer
        for i, leaves in enumerate(per_layer):
            x = layer(stack_layer, dict(zip(names, leaves)), x)
            if self._shared_after(i):
                x = layer(attn_layer, params["shared_attn"], x)
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
        dev = self.device
        cache = {"len": torch.zeros((), dtype=torch.int32, device=dev)}
        if c.family == "dense":
            n_kv = c.n_layers
        else:
            s = c.ssm
            din = s.expand * c.d_model
            cache["h"] = torch.zeros((c.n_layers, batch, din, s.state_dim),
                                     dtype=torch.float32, device=dev)
            cache["conv"] = torch.zeros((c.n_layers, batch, s.conv_dim - 1, din),
                                        dtype=self.cdt, device=dev)
            if c.family == "ssm":
                return cache
            n_kv = c.n_layers // c.shared_attn_every    # one per application
        kv = (n_kv, batch, max_len, c.n_kv_heads, c.hd)
        cache["k"] = torch.zeros(kv, dtype=self.cdt, device=dev)
        cache["v"] = torch.zeros(kv, dtype=self.cdt, device=dev)
        return cache

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
        """token: (B,) int -> (cache, logits (B, V) f32).  The cache's
        tensors are updated in place; ``len`` is advanced by one."""
        c = self.cfg
        length = cache["len"]
        pos, n_live = length.reshape(1).long(), length + 1
        x = params["emb"][token][:, None].to(self.cdt)       # (B, 1, D)
        for i in range(c.n_layers):
            bp = self._layer(params, i)
            if c.family == "dense":
                x = self._attn_decode(bp, x, cache["k"][i], cache["v"][i], pos, n_live)
                x = self._mlp(bp, x)
                continue
            x = self._ssm_decode(bp, x, cache["h"][i], cache["conv"][i])
            if self._shared_after(i):
                app, shared = i // c.shared_attn_every, params["shared_attn"]
                x = self._attn_decode(shared, x, cache["k"][app], cache["v"][app],
                                      pos, n_live)
                x = self._mlp(shared, x)
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
            bp = self._layer(params, i)
            if c.family == "dense":
                x, k, v = self._block(bp, x, positions)
                cache["k"][i, :, :s] = k
                cache["v"][i, :, :s] = v
                continue
            x, h_fin, conv_fin = self._ssm_block(bp, x)
            cache["h"][i] = h_fin
            cache["conv"][i] = conv_fin
            if self._shared_after(i):
                app = i // c.shared_attn_every
                x, k, v = self._block(params["shared_attn"], x, positions)
                cache["k"][app, :, :s] = k
                cache["v"][app, :, :s] = v
        x = rms_norm(x, params["out_norm"], c.norm_eps)
        logits = (x[:, -1] @ self.lm_head(params)).float()
        cache["len"].fill_(s)
        return cache, logits
