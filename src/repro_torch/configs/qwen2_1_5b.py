"""Qwen2-1.5B — GQA kv=2, QKV bias [arXiv:2407.10671; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536,
    n_heads=12, n_kv_heads=2, d_ff=8960, vocab=151936, head_dim=128,
    act="swiglu", qkv_bias=True, rope_theta=1000000.0, tie_embeddings=True)
