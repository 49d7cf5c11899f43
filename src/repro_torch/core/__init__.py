"""MemIntelli core: bit-sliced variable-precision dot-product engine."""
from .slicing import SliceSpec, slice_int, slice_significances, unslice
from .presets import (
    BF16,
    FLEX16_5,
    FP16,
    FP32,
    INT4,
    INT8,
    INT12,
    INT16,
    PRESETS,
    spec,
)
from .engine import DPEConfig
from .dpe import (
    FoldedWeight,
    PreparedWeight,
    dpe_apply,
    dpe_matmul,
    dpe_matmul_folded,
    dpe_matmul_prepared,
    prepare_input,
    prepare_weight,
    program_weight,
    resolve_backend,
)
from .layers import MemPolicy, layer_key, mem_linear

__all__ = [
    "DPEConfig",
    "SliceSpec",
    "slice_int",
    "unslice",
    "slice_significances",
    "INT4",
    "INT8",
    "INT12",
    "INT16",
    "FP16",
    "BF16",
    "FLEX16_5",
    "FP32",
    "PRESETS",
    "spec",
    "PreparedWeight",
    "FoldedWeight",
    "prepare_weight",
    "prepare_input",
    "program_weight",
    "dpe_matmul",
    "dpe_matmul_prepared",
    "dpe_matmul_folded",
    "dpe_apply",
    "resolve_backend",
    "MemPolicy",
    "layer_key",
    "mem_linear",
]
