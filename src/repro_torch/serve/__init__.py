"""Public serving surface of the port: build a :class:`ServeConfig`,
hand it to :class:`ServeLoop`, read the :class:`ServeReport`."""
from .batching import (
    Request,
    RequestQueue,
    RequestResult,
    ServeLoop,
    ServeReport,
    default_buckets,
)
from .config import ServeConfig
from .engine import make_chunk_prefill, make_decode_step
from .prefix_cache import AdmitPlan, PrefixCache

__all__ = [
    "ServeLoop",
    "ServeConfig",
    "ServeReport",
    "Request",
    "RequestResult",
    "PrefixCache",
    "AdmitPlan",
    "RequestQueue",
    "default_buckets",
    "make_chunk_prefill",
    "make_decode_step",
]
