"""Radix partition of coded rows into fixed-capacity hash buckets.

``ops.radix_partition`` is the entry point; ``ref`` holds the plain
PyTorch version and ``kernel`` the CUDA kernel's wrapper. Used by the
radix layout of the hash δ (:func:`repro_torch.relalg.ops.distinct_rows_hashed`).
"""
from .kernel import kernel_feasible, radix_partition_kernel
from .ops import radix_partition
from .ref import bucket_shift, bucket_targets_ref, radix_partition_ref

__all__ = [
    "bucket_shift", "bucket_targets_ref", "kernel_feasible",
    "radix_partition", "radix_partition_kernel", "radix_partition_ref",
]
