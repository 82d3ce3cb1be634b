"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206; encoder-decoder, multimodal. [arXiv:2308.11596]

The mel-spectrogram + conformer/conv feature frontend is a STUB per the
assignment carve-out: ``input_specs()`` provides precomputed frame
embeddings [B, 1024, 1024] consumed by the 12-layer bidirectional encoder;
the 12-layer text decoder (self + cross attention per block) is implemented
in full.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    n_layers=12,                   # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    layer_pattern=("global",),
    rope_theta=10_000.0,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    qkv_bias=True,
    tie_embeddings=True,
    encoder_layers=12,
    frontend="audio",
    frontend_len=1024,
    frontend_dim=1024,
)
