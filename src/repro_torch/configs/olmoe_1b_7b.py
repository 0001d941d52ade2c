"""OLMoE 1B-7B — MoE, 64 experts top-8. [arXiv:2409.02060; hf]
16L d_model=2048 16H (GQA kv=16) expert d_ff=1024 vocab=50304."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304, d_head=128,
    n_experts=64, top_k=8, capacity_factor=1.25, moe_impl="local",
    optimizer="adamw", fsdp=False, remat="full",
    microbatch_seq_tokens=1 << 18,
)
