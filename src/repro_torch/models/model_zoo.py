"""Model registry: ``get_model(family)`` returns the family module, whose
interface is uniform: ``param_specs`` / ``apply`` / ``cache_specs`` /
``prefill`` / ``decode_step``.

The JAX package's ``auto_rules`` (the per-mesh axis rules of its GSPMD
sharding) is not ported: the port runs one device.
"""
from __future__ import annotations

from types import ModuleType

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
