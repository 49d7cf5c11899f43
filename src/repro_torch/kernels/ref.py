"""Plain PyTorch oracle of the sliced-matmul kernels (port of
``repro/kernels/ref.py``).

Mirrors the kernel semantics exactly, including the ``dynamic`` ADC
range over one (bm x bn) tile of the ``bm``-row tiling (ref.py:74 of the
reference); ``dynamic_row`` ranges per row over the bit-line axis and
``fullscale`` is static, both independent of the row tiling.  The
accumulation order is the kernel's: K-blocks outer, slice pairs inner
(input slice major), per-block scales applied to each K-block's
accumulator, K-blocks summed in order from zero.

Each slice-pair dot is the CUDA kernel's chain of float32 fused
multiply-adds over the crossbar rows ``0..bk-1`` in order (every step
computed in float64 and rounded once more to float32, see :func:`fma`).
The ADC is a step function of that partial sum, so the order matters:
two float32 orders differ in the last bits often enough to move ADC
codes at rel-Fro ~5e-4 on qwen2-0.5b shapes, while a library GEMM's
order is unknown and changes with the shape.  A CPU ``einsum`` happens
to sum in this order too; the reference's does within 1e-5.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import div
from repro_torch.core.slicing import SliceSpec, slice_significances

__all__ = ["sliced_matmul_ref", "fma"]

_EPS = 1e-30
_CHUNK = 1 << 24  # partial sums held at once (bounds the plain version's memory)


def sliced_matmul_ref(
    xs: torch.Tensor,  # (Sx, M, Kp)
    sx: torch.Tensor,  # (M, nk)
    ws: torch.Tensor,  # (Sw, Kp, Np)
    sw: torch.Tensor,  # (nk, nn)
    *,
    input_spec: SliceSpec,
    weight_spec: SliceSpec,
    array_size: tuple[int, int],
    radc: int,
    adc_mode: str,
    bm: int = 128,
) -> torch.Tensor:
    bk, bn = array_size
    sxn, m, kp = xs.shape
    swn, _, np_ = ws.shape
    nk = kp // bk
    if m % bm or kp % bk or np_ % bn:
        raise ValueError(
            f"shapes must be tile multiples: M={m} bm={bm} Kp={kp} Np={np_}"
        )
    cols = max(bn, (_CHUNK // max(nk * sxn * m * swn * bn, 1)) * bn)
    return torch.cat([
        _sliced_matmul_cols(
            xs, sx, ws[:, :, c0:c0 + cols], sw[:, c0 // bn:(c0 + cols) // bn],
            input_spec=input_spec, weight_spec=weight_spec, array_size=array_size,
            radc=radc, adc_mode=adc_mode, bm=bm,
        )
        for c0 in range(0, np_, cols)
    ], dim=1)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a*b + c`` as the kernels' ``fmaf``: float64 holds the
    product of two float32 values exactly, and the sum is rounded to
    float64 and then to float32.  The two roundings differ from the one
    of a fused multiply-add only where the first lands exactly halfway
    between two float32 values without being exact, about once in 2**29
    inexact sums; the exact form, :func:`repro_torch.core.xmath.fma`,
    costs several times more on these slice-pair chains.  Broadcasts
    like ``torch.addcmul``."""
    return torch.addcmul(c.to(torch.float64), a.to(torch.float64), b.to(torch.float64)).to(
        torch.float32
    )


def _pair_dots(xs: torch.Tensor, ws: torch.Tensor, bk: int) -> torch.Tensor:
    """Every slice-pair partial sum of every K-block, (nk, Sx, M, Sw, N),
    as the kernel's in-order fused multiply-add chain over the rows."""
    sxn, m, kp = xs.shape
    swn, _, n = ws.shape
    nk = kp // bk
    x = xs.to(torch.float64).reshape(sxn, m, nk, bk).permute(2, 0, 1, 3)  # k i m b
    w = ws.to(torch.float64).reshape(swn, nk, bk, n).permute(1, 0, 2, 3)  # k j b n
    p = torch.zeros((nk, sxn, m, swn, n), dtype=torch.float32, device=xs.device)
    for r in range(bk):
        p = fma(x[:, :, :, r, None, None], w[:, None, None, :, r], p)
    return p


def _sliced_matmul_cols(xs, sx, ws, sw, *, input_spec, weight_spec, array_size,
                        radc, adc_mode, bm):
    """:func:`sliced_matmul_ref` over a slab of whole n-blocks."""
    bk, bn = array_size
    sxn, m, kp = xs.shape
    swn, _, np_ = ws.shape
    nk, nn = kp // bk, np_ // bn
    nm = m // bm
    sigx = slice_significances(input_spec)
    sigw = slice_significances(weight_spec)
    p = _pair_dots(xs, ws, bk)
    if radc > 1:
        p = p.reshape(nk, sxn, nm, bm, swn, nn, bn)
        if adc_mode == "dynamic":
            ymax = torch.clamp_min(p.amax(dim=(3, 6), keepdim=True), _EPS)
        elif adc_mode == "dynamic_row":
            ymax = torch.clamp_min(p.amax(dim=6, keepdim=True), _EPS)
        else:
            fs = [
                [bk * (2.0**bx - 1.0) * (2.0**bw - 1.0) for bw in weight_spec.bits]
                for bx in input_spec.bits
            ]
            ymax = torch.tensor(fs, dtype=torch.float32, device=p.device).reshape(
                1, sxn, 1, 1, swn, 1, 1
            )
        step = div(ymax, radc - 1)
        p = (torch.round(p / step) * step).reshape(nk, sxn, m, swn, np_)
    acc = torch.zeros((nk, m, np_), dtype=torch.float32, device=xs.device)
    for i in range(sxn):
        for j in range(swn):
            acc = acc + float(sigx[i] * sigw[j]) * p[:, i, :, j]
    # scale per (row, K-block) and (K-block, n-block)
    blk = acc * sx.t()[:, :, None] * torch.repeat_interleave(sw, bn, dim=1)[:, None, :]
    out = torch.zeros((m, np_), dtype=torch.float32, device=xs.device)
    for kb in range(nk):
        out = out + blk[kb]
    return out
