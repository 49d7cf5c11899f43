"""Bit-slicing of INT and FP (shared-exponent) data — MemIntelli §2.2 / §3.3.

Port of ``repro/core/slicing.py``.  A B-bit signed integer is decomposed
MSB-first into unsigned slices with widths ``bits = (b0, b1, ..)``.  For
signed specs the first slice is the sign bit and carries *negative*
significance ``-2**(B-1)`` (two's complement); all other slices carry
``+2**lsb_offset``.  FP data uses shared-exponent pre-alignment: the only
difference at this layer is a power-of-two block scale
(:mod:`repro_torch.core.quant`).  Integer paths are bitwise equal to the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SliceSpec", "slice_int", "unslice", "slice_significances"]


@dataclass(frozen=True)
class SliceSpec:
    """How one operand (input or weight) is bit-sliced.

    Attributes:
      kind:   "int" (symmetric per-block quantisation) or "fp"
              (shared-exponent / pre-alignment, power-of-two block scale).
      bits:   MSB-first slice widths.  For ``signed`` specs ``bits[0]`` must
              be 1 (the sign slice).
      signed: whether the underlying integer is two's complement.
    """

    kind: str
    bits: tuple[int, ...]
    signed: bool = True

    def __post_init__(self):
        if self.kind not in ("int", "fp"):
            raise ValueError(f"kind must be int|fp, got {self.kind!r}")
        if not self.bits or any(b < 1 for b in self.bits):
            raise ValueError(f"bad slice widths {self.bits}")
        if self.signed and self.bits[0] != 1:
            raise ValueError(
                "signed slice specs must start with a 1-bit sign slice, "
                f"got {self.bits}"
            )
        if self.total_bits > 30:
            raise ValueError("total bits > 30 would overflow int32 slicing")

    @property
    def total_bits(self) -> int:
        return int(sum(self.bits))

    @property
    def n_slices(self) -> int:
        return len(self.bits)

    @property
    def lsb_offsets(self) -> tuple[int, ...]:
        """LSB position of each slice (MSB-first order)."""
        offs, acc = [], self.total_bits
        for b in self.bits:
            acc -= b
            offs.append(acc)
        return tuple(offs)

    @property
    def qmin(self) -> int:
        return -(2 ** (self.total_bits - 1)) if self.signed else 0

    @property
    def qmax(self) -> int:
        b = self.total_bits
        return 2 ** (b - 1) - 1 if self.signed else 2**b - 1

    def with_kind(self, kind: str) -> "SliceSpec":
        return SliceSpec(kind, self.bits, self.signed)


def slice_significances(spec: SliceSpec) -> np.ndarray:
    """Signed recombination weight of every slice, MSB-first.  Static."""
    sig = np.array([2.0**o for o in spec.lsb_offsets], dtype=np.float64)
    if spec.signed:
        sig[0] = -(2.0 ** (spec.total_bits - 1))
    return sig


def slice_int(xq: torch.Tensor, spec: SliceSpec) -> torch.Tensor:
    """Decompose integer ``xq`` (values in ``[qmin, qmax]``) into unsigned
    slices: int32 ``(n_slices, *xq.shape)``, slice ``k`` holding the
    field of width ``bits[k]`` (MSB-first)."""
    xq = xq.to(torch.int32)
    # two's complement wrap into B bits: negatives become 2**B + x
    u = torch.bitwise_and(xq, (1 << spec.total_bits) - 1)
    outs = [
        torch.bitwise_and(torch.bitwise_right_shift(u, off), (1 << w) - 1)
        for w, off in zip(spec.bits, spec.lsb_offsets)
    ]
    return torch.stack(outs, dim=0)


def unslice(slices: torch.Tensor, spec: SliceSpec) -> torch.Tensor:
    """Inverse of :func:`slice_int` (float slices too — carries analog
    noise through the digital recombination)."""
    sig = torch.tensor(
        slice_significances(spec), dtype=torch.float32, device=slices.device
    ).reshape((spec.n_slices,) + (1,) * (slices.dim() - 1))
    return torch.sum(slices.to(torch.float32) * sig, dim=0)
