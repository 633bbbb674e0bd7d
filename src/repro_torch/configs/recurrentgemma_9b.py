"""RecurrentGemma-9B — RG-LRU + local attention 1:2 [arXiv:2402.19427]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256000, head_dim=256,
    act="geglu", scale_embed=True, pattern=("rec", "rec", "attn"),
    window=2048, rglru_dim=4096, tie_embeddings=True, sparse_kv=False)
