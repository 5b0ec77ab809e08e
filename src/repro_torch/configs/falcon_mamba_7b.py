"""falcon-mamba-7b [ssm]: attention-free Mamba1 stack.

64L, d_model=4096, ssm_state=16, vocab=65024.  [arXiv:2410.05355;
unverified]
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="falcon_mamba_7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    ssm=SSMConfig(state_dim=16, version=1, conv_dim=4, expand=2),
)
