"""Quantisation / pre-alignment and data-converter models — MemIntelli
§3.2-3.3 (port of ``repro/core/quant.py``).

* INT blocks: ``scale = absmax / (2**(B-1) - 1)``.
* FP blocks (pre-alignment): ``scale = 2**(floor(log2 absmax) - (B-2))``.
* ``rdac``-level DAC on word-line voltages, ``radc``-level ADC on
  bit-line currents.

All arithmetic is float32 with IEEE division and round-half-to-even
(``torch.round``), the same expression order as the reference, so the
integer paths are bitwise equal to it.  Divisions by a constant go
through :func:`div`: on a CUDA tensor PyTorch turns ``t / python_float``
into a multiplication by the reciprocal, which rounds differently.
"""
from __future__ import annotations

import torch

from .slicing import SliceSpec

_EPS = 1e-30


def div(t: torch.Tensor, s: float) -> torch.Tensor:
    """``t / s`` by IEEE division on every device (the divisor is a
    0-d tensor on ``t``'s device, never a host scalar)."""
    return t / t.new_full((), s)


def block_scale(absmax: torch.Tensor, spec: SliceSpec) -> torch.Tensor:
    """Per-block scale from the block's max |value|."""
    absmax = torch.clamp_min(absmax, _EPS)
    if spec.signed:
        levels = 2.0 ** (spec.total_bits - 1) - 1.0
    else:
        levels = 2.0**spec.total_bits - 1.0
    if spec.kind == "int":
        return div(absmax, levels)
    e = torch.floor(torch.log2(absmax))
    return torch.exp2(e - (spec.total_bits - 2))


def quantize(x: torch.Tensor, scale: torch.Tensor, spec: SliceSpec) -> torch.Tensor:
    """Round-to-nearest-even integer quantisation with saturation."""
    q = torch.round(x / scale)
    return torch.clamp(q, spec.qmin, spec.qmax).to(torch.int32)


def dac_quantize(v: torch.Tensor, rdac: int, vmax: float) -> torch.Tensor:
    """DAC with ``rdac`` levels across ``[0, vmax]``; the identity when
    the DAC grid is a superset of the slice's integer grid (the paper's
    8-bit DAC driving <=4-bit slices)."""
    if rdac <= 1:
        return v
    if (rdac - 1) % max(int(vmax), 1) == 0:
        return v
    step = vmax / (rdac - 1)
    return torch.round(div(v, step)) * step


def adc_quantize(y: torch.Tensor, radc: int, ymax) -> torch.Tensor:
    """ADC with ``radc`` levels across ``[0, ymax]``."""
    if radc <= 1:
        return y
    if not isinstance(ymax, torch.Tensor):
        ymax = torch.tensor(ymax, dtype=torch.float32, device=y.device)
    step = div(torch.clamp_min(ymax, _EPS), radc - 1)
    return torch.round(y / step) * step
