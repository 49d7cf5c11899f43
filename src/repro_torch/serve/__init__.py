"""Public serving surface of the port: build a :class:`ServeConfig`,
hand it to :class:`ServeLoop`, read the :class:`ServeReport`; or decode
one lockstep batch with :func:`greedy_generate`."""
from .batching import (
    Request,
    RequestQueue,
    RequestResult,
    ServeLoop,
    ServeReport,
    default_buckets,
)
from .config import ServeConfig
from .engine import (
    greedy_generate,
    make_chunk_prefill,
    make_decode_step,
    make_prefill_step,
    make_slot_prefill,
    make_verify_step,
)
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
    "greedy_generate",
    "make_prefill_step",
    "make_slot_prefill",
    "make_chunk_prefill",
    "make_decode_step",
    "make_verify_step",
    "SamplingParams",
    "GREEDY",
    "request_keys",
    "sample_row",
    "sample_rows",
]
