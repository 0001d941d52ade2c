from .kernel import hash_neighbor_flags_kernel, rowhash_kernel
from .ops import hash_neighbor_flags, rowhash
from .ref import hash_neighbor_flags_ref, rowhash_ref

__all__ = [
    "hash_neighbor_flags", "hash_neighbor_flags_kernel",
    "hash_neighbor_flags_ref", "rowhash", "rowhash_kernel", "rowhash_ref",
]
