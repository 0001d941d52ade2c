"""Gemma3 4B — dense GQA, 5:1 local:global attention, 128k context.
[hf:google/gemma-3-*; unverified] 34L d_model=2560 8H (GQA kv=4)
d_ff=10240 vocab=262144. Local layers use a 1024-token sliding window;
every 6th layer is global."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab_size=262144, d_head=256,
    local_global=5, window_size=1024, tied_embeddings=True,
    banded_local=True,
    rope_theta=1e6,
    optimizer="adamw", fsdp=True, remat="full",
    supports_long_context=True,
)
