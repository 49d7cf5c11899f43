"""Dense-decoder model substrate of the port: init, ``forward``, the
dense and the paged KV caches and the serving steps."""
from .config import ArchConfig, EncoderConfig, MoEConfig, SSMConfig
from .model import (
    copy_paged_block,
    decode_step,
    decode_verify_step,
    forward,
    init_cache,
    init_paged_cache,
    init_params,
    loss_fn,
    prefill_chunk_step,
    segments,
)
from .programmed import program_params, programmed_byte_size

__all__ = [
    "ArchConfig",
    "MoEConfig",
    "SSMConfig",
    "EncoderConfig",
    "init_params",
    "forward",
    "loss_fn",
    "init_cache",
    "init_paged_cache",
    "copy_paged_block",
    "decode_step",
    "decode_verify_step",
    "prefill_chunk_step",
    "segments",
    "program_params",
    "programmed_byte_size",
]
