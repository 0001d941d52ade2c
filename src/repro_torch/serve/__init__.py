"""Serving tier: the language models' token-decode loops AND the
multi-tenant KG ingest front door.

The decode helpers (:func:`make_prefill` & co., ``serve/decode.py``)
predate the front door and keep their import path. The streaming-service
surface is :class:`FrontDoor` plus its typed request/response vocabulary;
it re-exports from :mod:`repro_torch.api` as well, for the one-stop
stable surface, as in the reference.
"""
from .admission import (AdmissionController, IngestResult, Overloaded,
                        Ticket)
from .batcher import MicroBatcher, PendingRequest
from .decode import greedy_generate, make_prefill, make_serve_step
from .frontdoor import FrontDoor
from .registry import SessionRegistry, TenantSession
from .stats import LatencyWindow, percentile

__all__ = [
    "AdmissionController", "FrontDoor", "IngestResult", "LatencyWindow",
    "MicroBatcher", "Overloaded", "PendingRequest", "SessionRegistry",
    "TenantSession", "Ticket", "greedy_generate", "make_prefill",
    "make_serve_step", "percentile",
]
