"""Architecture configuration of the language models the port runs.

One :class:`ArchConfig` per architecture lives in ``configs/<id>.py``
(same fields and values as the JAX package's), for all ten of its
architectures; the four input-shape points are global (:data:`SHAPES`,
the reference's). ``reduced_config`` shrinks a config to a CPU-test size of
the same family (same block structure, tiny dims).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


def round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


# ---------------------------------------------------------------------------
# input shapes (seq_len x global_batch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0               # 0 => d_model // n_heads

    # dense-family options
    qk_norm: bool = False
    rope_theta: float = 10000.0
    local_global: int = 0
    window_size: int = 0
    banded_local: bool = False
    tied_embeddings: bool = False

    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "global"

    # ssm / rwkv / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    shared_attn_every: int = 0    # zamba2: shared attn block cadence

    # modality frontends
    n_prepend: int = 0
    n_enc_frames: int = 0

    # training / distribution settings, the JAX package's: the train
    # step, ``auto_rules`` and the dry-run read them, the forward none
    # (``use_pallas`` and ``unroll_layers`` are carried so that a config
    # compares field by field with the reference's: the models take the
    # reference's use_pallas=True route, a CUDA tensor always takes the
    # kernels, and the layers are a Python loop)
    remat: str = "full"
    fsdp: bool = False
    fsdp_pods: bool = False
    optimizer: str = "adamw"
    microbatch_seq_tokens: int = 1 << 22
    seq_shard_activations: bool = False
    use_pallas: Optional[bool] = None
    grad_compress_pods: bool = False
    unroll_layers: bool = False

    supports_long_context: bool = False
    supports_decode: bool = True

    def __post_init__(self):
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab_size, 128)

    @property
    def d_inner(self) -> int:     # mamba2 inner width
        return self.ssm_expand * self.d_model

    def shape_supported(self, shape: ShapeSpec) -> bool:
        if shape.kind == "decode" and not self.supports_decode:
            return False
        if shape.name == "long_500k" and not self.supports_long_context:
            return False
        return True

    def microbatches(self, shape: ShapeSpec, n_data_shards: int) -> int:
        """Grad-accum steps so one microbatch holds <= the token target."""
        if shape.kind != "train":
            return 1
        total = shape.seq_len * shape.global_batch
        mb = max(1, total // self.microbatch_seq_tokens)
        # microbatch count must divide global_batch / data shards evenly
        per_shard = shape.global_batch // n_data_shards
        while per_shard % mb and mb > 1:
            mb -= 1
        return mb


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

#: architectures the port runs (``configs/<id>.py``), in the JAX
#: package's order
ARCH_IDS = (
    "rwkv6_7b", "internlm2_20b", "qwen3_1p7b", "gemma3_4b",
    "mistral_large_123b", "olmoe_1b_7b", "kimi_k2_1t_a32b",
    "internvl2_2b", "zamba2_2p7b", "whisper_large_v3",
)

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES.update({
    "rwkv6-7b": "rwkv6_7b", "internlm2-20b": "internlm2_20b",
    "qwen3-1.7b": "qwen3_1p7b", "gemma3-4b": "gemma3_4b",
    "mistral-large-123b": "mistral_large_123b", "olmoe-1b-7b": "olmoe_1b_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b", "internvl2-2b": "internvl2_2b",
    "zamba2-2.7b": "zamba2_2p7b", "whisper-large-v3": "whisper_large_v3",
})


def list_archs() -> Tuple[str, ...]:
    return ARCH_IDS


def get_config(arch: str) -> ArchConfig:
    mod_name = _ALIASES.get(arch, arch)
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Same family/block structure at smoke-test scale (the reference's
    reduction, field for field)."""
    n_heads = min(cfg.n_heads, 4) or 0
    n_kv = (max(1, n_heads // max(1, cfg.n_heads // max(cfg.n_kv_heads, 1)))
            if cfg.n_kv_heads else 0)
    d_head = 16
    reps = {
        "n_layers": min(cfg.n_layers, 4),
        "d_model": d_head * max(n_heads, 2),
        "n_heads": n_heads,
        "n_kv_heads": n_kv,
        "d_head": d_head,
        "d_ff": 128,
        "vocab_size": 256,
        "n_experts": min(cfg.n_experts, 8),
        "top_k": min(cfg.top_k, 2),
        "ssm_state": min(cfg.ssm_state, 16),
        "n_prepend": min(cfg.n_prepend, 8),
        "n_enc_frames": min(cfg.n_enc_frames, 16),
        "window_size": min(cfg.window_size, 32) if cfg.window_size else 0,
        "local_global": cfg.local_global,
        "shared_attn_every": min(cfg.shared_attn_every, 2)
        if cfg.shared_attn_every else 0,
        "remat": "none",
        "fsdp": False,
        "fsdp_pods": False,
        "microbatch_seq_tokens": 1 << 22,
        "use_pallas": False,
    }
    if cfg.shared_attn_every:   # zamba2: keep groups aligned
        reps["n_layers"] = reps["shared_attn_every"] * 2
    if cfg.local_global:
        reps["n_layers"] = cfg.local_global + 1
    return dataclasses.replace(cfg, **reps)
