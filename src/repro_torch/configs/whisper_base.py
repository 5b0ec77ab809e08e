"""whisper-base [audio]: enc-dec transformer backbone, conv frontend STUB.

6L (enc) + 6L (dec), d_model=512, 8H (kv=8), d_ff=2048, vocab=51865.
[arXiv:2212.04356; unverified]  Frontend: input_specs() provides
precomputed (batch, 1500, d_model) frame embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper_base",
    family="encdec",
    n_layers=6,            # decoder layers
    enc_layers=6,
    enc_seq=1500,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    mlp_type="gelu",       # whisper uses 2-matrix GELU MLPs
    rope_style="full",     # decoder uses learned positions (rope=False paths)
)
