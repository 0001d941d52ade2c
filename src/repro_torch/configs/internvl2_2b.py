"""InternVL2 2B — VLM: stub InternViT frontend + InternLM2-1.8B backbone.
[arXiv:2404.16821; hf] 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553; 256 precomputed patch embeddings prepended."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92553, d_head=128,
    n_prepend=256,
    optimizer="adamw", fsdp=False, remat="full",
)
