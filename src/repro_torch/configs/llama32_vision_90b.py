"""llama-3.2-vision-90b [vlm]: cross-attn image layers every 5th layer.

100L, d_model=8192, 64H (GQA kv=8), d_ff=28672, vocab=128256.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  Vision frontend STUB:
input_specs() provides precomputed (batch, img_tokens, d_model) patch
embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama32_vision_90b",
    family="vlm",
    n_layers=100,          # 80 self + 20 cross (every 5th)
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    cross_attn_every=5,
    img_tokens=1600,       # ~4 tiles x 400 patches
    rope_theta=500000.0,
)
