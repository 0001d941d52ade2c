"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 (+1 shared).
[arXiv:2501.kimi2 paper-table; unverified]
61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840.
About 1.03T parameters in all, about 32B active per token."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840, d_head=112,
    n_experts=384, top_k=8, n_shared_experts=1, capacity_factor=1.25,
    moe_impl="local",
    optimizer="adafactor", fsdp=True, fsdp_pods=True, remat="full",
    seq_shard_activations=True,
    microbatch_seq_tokens=1 << 16,
)
