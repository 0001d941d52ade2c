"""Serving entry points of the language models (``serve/decode.py``)."""
from .decode import greedy_generate, make_prefill, make_serve_step

__all__ = ["greedy_generate", "make_prefill", "make_serve_step"]
