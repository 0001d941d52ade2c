"""RWKV6 "Finch" 7B — attention-free, data-dependent decay.
[arXiv:2404.05892; hf] 32L d_model=4096 d_ff=14336 vocab=65536."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="rwkv",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=0,
    d_ff=14336, vocab_size=65536, d_head=64,
    ssm_head_dim=64, ssm_state=64,
    optimizer="adamw", fsdp=True, remat="full",
    supports_long_context=True,
)
