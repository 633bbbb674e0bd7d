"""Mamba2-130M — SSD (state-space duality) [arXiv:2405.21060]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=64,
    conv_width=4, sparse_kv=False)
