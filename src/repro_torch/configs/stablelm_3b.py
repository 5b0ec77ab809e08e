"""stablelm-3b [dense]: MHA (kv=32).

32L, d_model=2560, 32H (kv=32), d_ff=6912, vocab=50304.
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm_3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50304,
)
