"""Model registry + per-(config, mesh, shape) automatic axis rules.

``get_model(family)`` returns the family module, whose interface is
uniform: ``param_specs`` / ``apply`` / ``cache_specs`` / ``prefill`` /
``decode_step``.

``auto_rules`` builds the AxisRules table for a concrete (config, mesh,
shape), as the JAX package's does, line for line: every tensor-parallel
candidate axis is divisibility-checked against the mesh (e.g. gemma3's 8
q heads cannot shard over model=16 -> replicated; its ffn=10240 can).
When the kv-head dim cannot use the ``model`` axis, the KV-cache
*sequence* dim takes it instead. It reads only ``mesh.shape``.
"""
from __future__ import annotations

from types import ModuleType

from repro_torch.distributed.sharding import AxisRules

from . import encdec, moe, rwkv6, transformer, vlm, zamba2

MODEL_FAMILIES = {
    "dense": transformer,
    "moe": moe,
    "rwkv": rwkv6,
    "hybrid": zamba2,
    "encdec": encdec,
    "vlm": vlm,
}


def get_model(family: str) -> ModuleType:
    try:
        return MODEL_FAMILIES[family]
    except KeyError:
        raise KeyError(f"unknown family {family!r}; "
                       f"known: {sorted(MODEL_FAMILIES)}")


def _div(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def auto_rules(cfg, mesh, shape=None) -> AxisRules:
    """Divisibility-checked logical->mesh table for this (arch, mesh)."""
    model_n = mesh.shape.get("model", 1)
    data_n = mesh.shape.get("data", 1)
    pod_n = mesh.shape.get("pod", 1)
    rules = []

    # batch: prefer (pod, data), fall back, else replicate (long_500k B=1)
    if shape is not None:
        gb = shape.global_batch
        if pod_n > 1 and _div(gb, pod_n * data_n):
            rules.append(("batch", ("pod", "data")))
        elif _div(gb, data_n):
            rules.append(("batch", "data"))
        else:
            rules.append(("batch", None))
    else:
        if pod_n > 1:
            rules.append(("batch", ("pod", "data")))
        rules.append(("batch", "data"))

    # tensor-parallel candidates, divisibility-checked
    has_model = "model" in mesh.shape

    def tp(logical: str, dim: int):
        rules.append((logical, "model")
                     if has_model and _div(dim, model_n)
                     else (logical, None))

    tp("heads", cfg.n_heads)
    tp("kv_heads", cfg.n_kv_heads)
    tp("ffn", cfg.d_ff)
    tp("vocab", cfg.vocab_padded)
    tp("heads_flat", cfg.d_model)          # rwkv fused head dim
    tp("embed_out", cfg.d_model)           # square d->d projections
    if cfg.n_experts:
        tp("expert", cfg.n_experts)
    if cfg.family in ("hybrid",):
        tp("ssm_inner", 2 * cfg.d_inner + 2 * cfg.ssm_state +
           cfg.d_inner // cfg.ssm_head_dim)
        rules.append(("embed_cat", None))

    # KV cache seq dim: give the model axis to whoever can't use it
    kv_sharded = _div(cfg.n_kv_heads, model_n)
    rules.append(("kv_seq", "model" if has_model and not kv_sharded
                  else None))

    # FSDP: shard the non-TP param dim over data (within pod) or (pod,data)
    if cfg.fsdp and _div(cfg.d_model, data_n):
        if cfg.fsdp_pods and pod_n > 1:
            rules.append(("embed", ("pod", "data")))
        else:
            rules.append(("embed", "data"))
    rules.append(("embed", None))
    if cfg.fsdp and cfg.n_experts and _div(cfg.d_ff, data_n):
        rules.append(("expert_ffn",
                      ("pod", "data") if cfg.fsdp_pods and pod_n > 1
                      else "data"))
    rules.append(("expert_ffn", None))

    # sequence parallelism on residual-stream checkpoints
    seq_ok = shape is None or _div(shape.seq_len, model_n)
    rules.append(("seq_sp", "model")
                 if (has_model and cfg.seq_shard_activations and seq_ok)
                 else ("seq_sp", None))
    rules += [("seq", None), ("state", None), ("head_dim", None),
              ("layers", None), ("groups", None)]
    return AxisRules(tuple(rules))
