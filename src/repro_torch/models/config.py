"""Model configuration for the assigned architecture pool.

One ``ModelConfig`` drives every family (dense / MoE / SSM / hybrid /
enc-dec / VLM) through the same block-stack builder.  Dimensions that
must divide the mesh's model axis are padded at construction
(``pad_to``) — vocab padding is standard practice and noted in
DESIGN.md.

A copy of ``repro.models.config``: the port imports nothing of the JAX
package, so it keeps its own copy of this plain-data module.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int
    version: int = 1          # 1 = Mamba, 2 = Mamba2 (SSD)
    conv_dim: int = 4
    expand: int = 2
    headdim: int = 64         # mamba2 heads


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str               # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_type: str = "swiglu"  # swiglu (3 mats) | gelu (2 mats, whisper)
    rope_style: str = "full"  # full | half (chatglm 2d RoPE)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    moe_group_routing: bool = True   # per-sequence capacity (shardable)
    sharded_decode: bool = False     # shard_map flash-decode (seq-sharded KV)
    ssm_scan_dtype: str = "float32"  # "bfloat16": halve scan HBM traffic
    ssm: SSMConfig | None = None
    # hybrid (zamba2-style): one shared attention block applied every
    # ``shared_attn_every`` ssm layers
    shared_attn_every: int = 0
    # enc-dec (whisper-style)
    enc_layers: int = 0
    enc_seq: int = 0          # stubbed frontend sequence length (frames)
    # vlm (llama-3.2-vision-style): one cross-attention layer every
    # ``cross_attn_every`` self-attention layers
    cross_attn_every: int = 0
    img_tokens: int = 0       # stubbed patch-embedding count
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # padding granularity for shardable dims
    pad_to: int = 256

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab, self.pad_to)

    @property
    def is_causal_lm(self) -> bool:
        return self.family in ("dense", "moe", "ssm", "hybrid", "vlm")

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def params_dense_layer(self) -> int:
        """Approximate parameter count of one transformer layer."""
        hd = self.hd
        attn = (self.d_model * self.n_heads * hd          # q
                + 2 * self.d_model * self.n_kv_heads * hd  # k, v
                + self.n_heads * hd * self.d_model)        # o
        if self.moe is not None:
            mlp = (self.moe.n_experts * 3 * self.d_model * self.moe.expert_d_ff
                   + self.d_model * self.moe.n_experts)    # router
        else:
            n_mats = 2 if self.mlp_type == "gelu" else 3
            mlp = n_mats * self.d_model * self.d_ff
        return attn + mlp

    def param_count(self) -> int:
        """Approximate total parameters (for 6ND roofline math)."""
        n = self.padded_vocab * self.d_model
        if not self.tie_embeddings:
            n += self.padded_vocab * self.d_model
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * self.d_model
            per = (2 * self.d_model * d_in        # in_proj (x, z)
                   + d_in * s.conv_dim
                   + d_in * (2 * s.state_dim + 1)  # B, C, dt per-dim-ish
                   + d_in * self.d_model)          # out_proj
            n += self.n_layers * per
        elif self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * self.d_model
            per = (2 * self.d_model * d_in + d_in * s.conv_dim
                   + d_in * (2 * s.state_dim + 1) + d_in * self.d_model)
            n += self.n_layers * per
            n += self.params_dense_layer()  # one shared attn+mlp block
        elif self.family == "encdec":
            n += (self.enc_layers + self.n_layers) * self.params_dense_layer()
            # decoder cross-attention
            hd = self.hd
            n += self.n_layers * 2 * self.d_model * self.n_kv_heads * hd
        else:
            n += self.n_layers * self.params_dense_layer()
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        expert_all = (self.n_layers * self.moe.n_experts * 3
                      * self.d_model * self.moe.expert_d_ff)
        expert_active = (self.n_layers * self.moe.top_k * 3
                         * self.d_model * self.moe.expert_d_ff)
        return full - expert_all + expert_active

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw: dict = dict(
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=min(self.n_kv_heads, 4) or 2,
            d_ff=128, vocab=128, pad_to=16,
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(n_experts=4, top_k=min(self.moe.top_k, 2),
                                  expert_d_ff=64)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(state_dim=8, version=self.ssm.version,
                                  conv_dim=4, expand=2, headdim=16)
        if self.family == "hybrid":
            kw["shared_attn_every"] = 2
            kw["n_layers"] = 4
        if self.family == "encdec":
            kw["enc_layers"] = 2
            kw["enc_seq"] = 16
        if self.family == "vlm":
            kw["cross_attn_every"] = 2
            kw["n_layers"] = 4
            kw["img_tokens"] = 16
        return replace(self, **kw)
