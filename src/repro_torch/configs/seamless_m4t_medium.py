"""SeamlessM4T-medium — enc-dec, speech frontend stubbed
[arXiv:2308.11596; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec", n_layers=12,
    n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=256206, head_dim=64, act="relu", src_len=3200,
    tie_embeddings=True)
