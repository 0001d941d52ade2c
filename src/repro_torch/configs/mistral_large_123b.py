"""Mistral Large 123B — dense GQA.
[hf:mistralai/Mistral-Large-Instruct-2407; unverified]
88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab_size=32768, d_head=128,
    rope_theta=1e6,
    optimizer="adafactor", fsdp=True, remat="full",
    seq_shard_activations=True,
    microbatch_seq_tokens=1 << 16,
)
