"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; RG-LRU + local attention, 2:1 recurrent:attention blocks
(Griffin). [arXiv:2402.19427]
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    layer_pattern=("rglru", "rglru", "local"),
    window=2048,
    rope_theta=10_000.0,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    lru_width=4096,
)
