"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision]

The ViT vision encoder + projector is a STUB per the assignment carve-out:
``input_specs()`` provides precomputed patch embeddings [B, 1600, 1280]
(the transformer backbone implemented here consumes them via gated
cross-attention layers).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    layer_pattern=("global", "global", "global", "global", "cross"),
    rope_theta=500_000.0,
    act="silu",
    tie_embeddings=False,
    frontend="vision",
    frontend_len=1600,
    frontend_dim=1280,
)
