from .kernel import rwkv6_kernel
from .ops import rwkv6
from .ref import rwkv6_chunked, rwkv6_scan_ref

__all__ = ["rwkv6", "rwkv6_chunked", "rwkv6_kernel", "rwkv6_scan_ref"]
