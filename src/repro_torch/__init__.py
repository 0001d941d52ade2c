"""PyTorch/CUDA port of the MapSDI knowledge-graph creation pipeline.

The package mirrors ``src/repro/`` module by module (``repro_torch.relalg.
ops`` is the counterpart of ``repro.relalg.ops``) and imports neither jax
nor anything of ``repro``. Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; the δ hot path runs hand-written CUDA
kernels for Hopper (``kernels/csrc/``), built at first use.
"""
