"""Gemma-7B — GeGLU, head_dim=256 [arXiv:2403.08295; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense", n_layers=28, d_model=3072,
    n_heads=16, n_kv_heads=16, d_ff=24576, vocab=256000, head_dim=256,
    act="geglu", scale_embed=True, rope_theta=10000.0, tie_embeddings=True)
