"""Whisper large-v3 — encoder-decoder, stub conv frontend.
[arXiv:2212.04356; unverified] 32L(enc)+32L(dec) d_model=1280 20H (MHA
kv=20) d_ff=5120 vocab=51866; the model takes 1500 precomputed frame
embeddings (the conv frontend's output)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866, d_head=64,
    n_enc_frames=1500,
    optimizer="adamw", fsdp=False, remat="full",
)
