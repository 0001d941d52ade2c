from .kernel import mamba2_ssd_kernel
from .ops import mamba2_ssd
from .ref import mamba2_ssd_ref, ssd_chunked, ssd_scan_ref

__all__ = ["mamba2_ssd", "mamba2_ssd_kernel", "mamba2_ssd_ref",
           "ssd_chunked", "ssd_scan_ref"]
