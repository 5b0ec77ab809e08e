"""granite-moe-3b-a800m [moe]: 40 experts top-8.

32L, d_model=1536, 24H (GQA kv=8), expert d_ff=512, vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="granite_moe_3b",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=40, top_k=8, expert_d_ff=512),
    tie_embeddings=True,
)
