"""Zamba2 2.7B — Mamba2 backbone + weight-shared attention block.
[arXiv:2411.15242; hf] 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64; shared attn+MLP block every 6 mamba layers."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000, d_head=80,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, shared_attn_every=6,
    optimizer="adamw", fsdp=False, remat="full",
    supports_long_context=True,
)
