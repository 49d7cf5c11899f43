"""Slice-method presets matching the paper's experiments (copy of
``repro/core/presets.py``): INT4 -> (1,1,2), INT8 -> (1,1,2,4),
FP16 -> (1,1,2,4,4); the other FP formats follow the same pattern."""
from __future__ import annotations

from .slicing import SliceSpec

INT4 = SliceSpec("int", (1, 1, 2))
INT8 = SliceSpec("int", (1, 1, 2, 4))
INT12 = SliceSpec("int", (1, 1, 2, 4, 4))
INT16 = SliceSpec("int", (1, 1, 2, 4, 4, 4))

FP16 = SliceSpec("fp", (1, 1, 2, 4, 4))          # 12-bit eff. mantissa
BF16 = SliceSpec("fp", (1, 1, 2, 4))             # 8-bit eff. mantissa
FLEX16_5 = SliceSpec("fp", (1, 1, 2, 4, 4, 4))   # Flexpoint16+5
FP32 = SliceSpec("fp", (1, 1, 2, 4, 4, 4, 4, 4))  # 24-bit eff. mantissa

PRESETS = {
    "int4": INT4,
    "int8": INT8,
    "int12": INT12,
    "int16": INT16,
    "fp16": FP16,
    "bf16": BF16,
    "flex16_5": FLEX16_5,
    "fp32": FP32,
}


def spec(name: str) -> SliceSpec:
    try:
        return PRESETS[name.lower()]
    except KeyError:
        raise KeyError(f"unknown slice preset {name!r}; have {sorted(PRESETS)}")
