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
from .engine import make_chunk_prefill, make_decode_step, make_verify_step
from .prefix_cache import AdmitPlan, PrefixCache
from .sampling import GREEDY, SamplingParams, request_keys, sample_row, sample_rows

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
    "make_verify_step",
    "SamplingParams",
    "GREEDY",
    "request_keys",
    "sample_row",
    "sample_rows",
]
