"""Qwen2-VL-72B backbone — M-RoPE, vision frontend stubbed
[arXiv:2409.12191; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=29568, vocab=152064, head_dim=128,
    act="swiglu", qkv_bias=True, rope_theta=1000000.0,
    mrope_sections=(16, 24, 24), n_patches=1024)
