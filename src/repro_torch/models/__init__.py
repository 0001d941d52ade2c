"""Model registry: ``get_model(family)`` returns the family module
(``param_specs`` / ``apply`` / ``cache_specs`` / ``prefill`` /
``decode_step``). The port runs the ``rwkv``, ``hybrid`` and ``encdec``
families; the others are queued in ROADMAP.md."""
from __future__ import annotations

from types import ModuleType

from . import encdec, rwkv6, zamba2

MODEL_FAMILIES = {
    "rwkv": rwkv6,
    "hybrid": zamba2,
    "encdec": encdec,
}
#: the JAX package's other families, not ported yet
QUEUED_FAMILIES = ("dense", "moe", "vlm")


def get_model(family: str) -> ModuleType:
    if family in QUEUED_FAMILIES:
        raise NotImplementedError(
            f"the {family!r} family is not ported yet; ROADMAP.md (Queue 1, "
            "item 8) queues it")
    try:
        return MODEL_FAMILIES[family]
    except KeyError:
        raise KeyError(f"unknown family {family!r}; known: "
                       f"{sorted(MODEL_FAMILIES) + list(QUEUED_FAMILIES)}")


__all__ = ["MODEL_FAMILIES", "get_model"]
