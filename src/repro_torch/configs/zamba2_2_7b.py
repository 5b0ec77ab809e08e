"""zamba2-2.7b [hybrid]: Mamba2 stack + shared attention block.

54L, d_model=2560, 32H (kv=32), d_ff=10240, ssm_state=64, vocab=32000.
[arXiv:2411.15242; hf]  One shared attn+MLP block applied every 6
Mamba2 layers (weights shared across applications).
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2_2_7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm=SSMConfig(state_dim=64, version=2, conv_dim=4, expand=2),
    shared_attn_every=6,
)
