"""chatglm3-6b [dense]: 2d RoPE (half rotary), GQA kv=2.

28L, d_model=4096, 32H (GQA kv=2), d_ff=13696, vocab=65024.
[arXiv:2406.12793; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="chatglm3_6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    rope_style="half",
    qkv_bias=True,
)
