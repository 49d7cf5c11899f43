"""Variable-precision bit-sliced dot-product engine — MemIntelli §3.3
(port of ``repro/core/dpe.py``).

``y ≈ x @ w``: the weight is tiled into ``array_size = (bk, bn)``
crossbar tiles, quantised per block, bit-sliced and programmed with
log-normal noise; the input is quantised per (row, K-block), sliced and
DAC'd; every (input-slice x weight-slice) pair is one analog matmul per
K-block whose bit-line current is ADC-quantised; partial sums are
recombined digitally.  Modes: ``faithful`` (paper semantics), ``fast``
(digital slice folding, exact when the ADC is ideal) and ``digital``.

Faithful layers with backend ``auto``/``pallas`` go through the fused
sliced matmul of :mod:`repro_torch.kernels.ops` — the hand-written CUDA
kernel on a CUDA tensor, its plain version on the CPU.  Backend ``xla``
keeps the vectorized plain engine :func:`_faithful_matmul`;
:func:`_faithful_matmul_loop` is the seed slice-pair loop, kept verbatim
as the oracle.  The circuit backend is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops as _kops

from .device import noisy_slice_values
from .engine import DPEConfig
from .quant import adc_quantize, block_scale, dac_quantize, div, quantize
from .rng import fold_in
from .slicing import slice_int, slice_significances

__all__ = [
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
]


class PreparedWeight(NamedTuple):
    """A weight matrix programmed onto (simulated) crossbar tiles.

    slices: (Sw, Kp, Np) float32 — noisy slice values (analog domain).
    scale:  (nk, nn)     float32 — per-block quant / pre-alignment scale.
    t_prog: programming timestamp (metadata; drift is not ported).
    """

    slices: torch.Tensor
    scale: torch.Tensor
    t_prog: float | None = None


class FoldedWeight(NamedTuple):
    """Fast-mode programmed state: the digitally folded noisy effective
    weight (Kp, Np) in ``cfg.store_dtype``."""

    w_eff: torch.Tensor
    t_prog: float | None = None


def _store_dtype(cfg: DPEConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.store_dtype == "bf16" else torch.float32


def _pad_to(a: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    rem = (-a.shape[axis]) % mult
    if rem == 0:
        return a
    shape = list(a.shape)
    shape[axis] = rem
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _quantize_weight(w: torch.Tensor, cfg: DPEConfig):
    """Pad to whole tiles, quantise per (bk, bn) block.  Returns the
    two's-complement-wrapped codes (nk, bk, nn, bn) and the block scales."""
    bk, bn = cfg.array_size
    spec = cfg.weight_spec
    wp = _pad_to(_pad_to(w.to(torch.float32), 0, bk), 1, bn)
    kp, np_ = wp.shape
    wb = wp.reshape(kp // bk, bk, np_ // bn, bn)
    scale = block_scale(wb.abs().amax(dim=(1, 3)), spec)
    wq = quantize(wb, scale[:, None, :, None], spec)
    u = torch.bitwise_and(wq, (1 << spec.total_bits) - 1)
    return u, scale


def _slice_field(u: torch.Tensor, off: int, width: int) -> torch.Tensor:
    return torch.bitwise_and(
        torch.bitwise_right_shift(u, off), (1 << width) - 1
    ).to(torch.float32)


def prepare_weight(
    w: torch.Tensor, cfg: DPEConfig, key: int | None = None
) -> PreparedWeight:
    """Quantise, slice and 'program' a weight matrix (the paper's
    ``update_weight()``).  ``key`` drives programming noise (slice ``s``
    draws with ``fold_in(key, s)``); None means ideal devices.  The
    slices are written one at a time, so the transient memory is one
    slice plane, not the whole integer slice stack."""
    if w.dim() != 2:
        raise ValueError(f"weights must be 2-D, got {tuple(w.shape)}")
    spec = cfg.weight_spec
    u, scale = _quantize_weight(w, cfg)
    nk, bk, nn, bn = u.shape
    out = torch.empty(
        (spec.n_slices, nk * bk, nn * bn), dtype=torch.float32,
        device=w.device,
    )
    for s, (width, off) in enumerate(zip(spec.bits, spec.lsb_offsets)):
        v = _slice_field(u, off, width)
        if cfg.cv > 0.0 and key is not None:
            v = noisy_slice_values(
                fold_in(key, s), v, width, cfg.hgs, cfg.lgs, cfg.cv
            )
        out[s] = v.reshape(nk * bk, nn * bn)
    return PreparedWeight(slices=out, scale=scale)


def prepare_input(x: torch.Tensor, cfg: DPEConfig):
    """Quantise + slice + DAC the input.

    x: (M, K) float.  Returns xs (Sx, M, Kp) float32 DAC'd slice values
    and sx (M, nk) scales.
    """
    bk, _ = cfg.array_size
    spec = cfg.input_spec
    xp = _pad_to(x.to(torch.float32), 1, bk)
    m, kp = xp.shape
    xb = xp.reshape(m, kp // bk, bk)
    sx = block_scale(xb.abs().amax(dim=2), spec)
    xq = quantize(xb, sx[:, :, None], spec)
    xs = slice_int(xq, spec).to(torch.float32)
    outs = [
        dac_quantize(xs[s], cfg.rdac, float(2**width - 1))
        for s, width in enumerate(spec.bits)
    ]
    return torch.stack(outs, dim=0).reshape(spec.n_slices, m, kp), sx


def _adc_fullscale(cfg: DPEConfig, bx: int, bw: int) -> float:
    bk, _ = cfg.array_size
    return float(bk) * (2.0**bx - 1.0) * (2.0**bw - 1.0)


def _pair_fullscale(cfg: DPEConfig, device) -> torch.Tensor:
    """Static per-pair ADC full-scale, shape (Sx, 1, Sw, 1, 1)."""
    fs = [
        [_adc_fullscale(cfg, bx, bw) for bw in cfg.weight_spec.bits]
        for bx in cfg.input_spec.bits
    ]
    return torch.tensor(fs, dtype=torch.float32, device=device).reshape(
        cfg.input_spec.n_slices, 1, cfg.weight_spec.n_slices, 1, 1
    )


def _pair_significances(cfg: DPEConfig, device) -> torch.Tensor:
    """Recombination weight of each (input-slice, weight-slice) pair,
    shape (Sx, Sw)."""
    sigx = slice_significances(cfg.input_spec)
    sigw = slice_significances(cfg.weight_spec)
    return torch.tensor(
        sigx[:, None] * sigw[None, :], dtype=torch.float32, device=device
    )


def _faithful_matmul(xs, sx, ws, sw, cfg: DPEConfig) -> torch.Tensor:
    """Vectorized faithful engine: per K-block one batched contraction
    over every slice pair, the per-pair ADC on the stacked partial sums,
    one recombination against the pair-significance table.  ``dynamic``
    ranges over all M rows of the call; an ideal ADC (``radc <= 1``)
    collapses exactly to :func:`_fast_matmul`.

    xs: (Sx, M, Kp); sx: (M, nk); ws: (Sw, Kp, Np); sw: (nk, nn).
    Returns (M, Np) float32.
    """
    if cfg.radc <= 1:
        return _fast_matmul(xs, sx, ws, sw, cfg)
    bk, bn = cfg.array_size
    sxn, m, kp = xs.shape
    swn, _, np_ = ws.shape
    nk, nn = kp // bk, np_ // bn
    sig_pair = _pair_significances(cfg, xs.device)[:, None, :, None, None]
    ymax_fs = _pair_fullscale(cfg, xs.device)
    xsb = xs.reshape(sxn, m, nk, bk)
    wsb = ws.reshape(swn, nk, bk, np_)
    acc = torch.zeros((m, np_), dtype=torch.float32, device=xs.device)
    for kb in range(nk):
        p = torch.einsum("imb,jbn->imjn", xsb[:, :, kb], wsb[:, kb]).reshape(
            sxn, m, swn, nn, bn
        )
        if cfg.adc_mode == "dynamic":
            ymax = p.amax(dim=4, keepdim=True).amax(dim=1, keepdim=True)
        elif cfg.adc_mode == "dynamic_row":
            ymax = p.amax(dim=4, keepdim=True)
        else:
            ymax = ymax_fs
        step = div(torch.clamp_min(ymax, 1e-30), cfg.radc - 1)
        out = ((sig_pair * step) * torch.round(p / step)).sum(dim=(0, 2))
        out = out * sx[:, kb][:, None, None] * sw[kb][None, :, None]
        acc = acc + out.reshape(m, np_)
    return acc


def _faithful_matmul_loop(xs, sx, ws, sw, cfg: DPEConfig) -> torch.Tensor:
    """Seed (pre-vectorization) slice-pair loop — kept verbatim as the
    equivalence oracle for :func:`_faithful_matmul`.  Do not optimise
    this function."""
    bk, bn = cfg.array_size
    sxn, m, kp = xs.shape
    swn, _, np_ = ws.shape
    nk, nn = kp // bk, np_ // bn
    sigx = slice_significances(cfg.input_spec)
    sigw = slice_significances(cfg.weight_spec)
    xsb = xs.reshape(sxn, m, nk, bk)
    wsb = ws.reshape(swn, nk, bk, np_)
    acc = torch.zeros((m, np_), dtype=torch.float32, device=xs.device)
    for kb in range(nk):
        xk = xsb[:, :, kb]
        wk = wsb[:, kb]
        out = torch.zeros((m, nn, bn), dtype=torch.float32, device=xs.device)
        for i in range(sxn):
            for j in range(swn):
                p = (xk[i] @ wk[j]).reshape(m, nn, bn)
                if cfg.radc > 1:
                    if cfg.adc_mode == "dynamic":
                        ymax = p.amax(dim=(0, 2), keepdim=True)
                    elif cfg.adc_mode == "dynamic_row":
                        ymax = p.amax(dim=2, keepdim=True)
                    else:
                        ymax = _adc_fullscale(
                            cfg, cfg.input_spec.bits[i], cfg.weight_spec.bits[j]
                        )
                    p = adc_quantize(p, cfg.radc, ymax)
                out = out + float(sigx[i] * sigw[j]) * p
        out = out * sx[:, kb][:, None, None] * sw[kb][None, :, None]
        acc = acc + out.reshape(m, np_)
    return acc


def _fast_matmul(xs, sx, ws, sw, cfg: DPEConfig) -> torch.Tensor:
    """Beyond-paper: digitally fold slices *before* one GEMM (identical
    to the faithful path when the ADC is ideal)."""
    bk, bn = cfg.array_size
    sxn, m, kp = xs.shape
    swn, _, np_ = ws.shape
    nk, nn = kp // bk, np_ // bn
    dev = xs.device
    sigx = torch.tensor(slice_significances(cfg.input_spec), dtype=torch.float32, device=dev)
    sigw = torch.tensor(slice_significances(cfg.weight_spec), dtype=torch.float32, device=dev)
    x_eff = torch.einsum("s,smk->mk", sigx, xs)
    w_eff = torch.einsum("s,skn->kn", sigw, ws)
    x_deq = (x_eff.reshape(m, nk, bk) * sx[:, :, None]).reshape(m, kp)
    w_deq = (w_eff.reshape(nk, bk, nn, bn) * sw[:, None, :, None]).reshape(kp, np_)
    return x_deq @ w_deq


def fold_weight_noisy(
    w: torch.Tensor, cfg: DPEConfig, key: int | None = None
) -> torch.Tensor:
    """Fast-mode weight pipeline: quantise per block, apply per-slice
    programming noise, recombine digitally — never materialising the
    (Sw, K, N) slice stack.  Returns (Kp, Np) in ``cfg.store_dtype``."""
    spec = cfg.weight_spec
    u, scale = _quantize_weight(w, cfg)
    sig = slice_significances(spec)
    acc = torch.zeros(u.shape, dtype=torch.float32, device=w.device)
    for s, (width, off) in enumerate(zip(spec.bits, spec.lsb_offsets)):
        v = _slice_field(u, off, width)
        if cfg.cv > 0.0 and key is not None:
            v = noisy_slice_values(
                fold_in(key, s), v, width, cfg.hgs, cfg.lgs, cfg.cv
            )
        acc = acc + float(sig[s]) * v
    nk, bk, nn, bn = u.shape
    w_deq = acc * scale[:, None, :, None]
    return w_deq.reshape(nk * bk, nn * bn).to(_store_dtype(cfg))


def fake_quant_input(x: torch.Tensor, cfg: DPEConfig) -> torch.Tensor:
    """Fast-mode input pipeline: per-block quantise + dequantise.
    x: (M, K) -> (M, Kp) in store_dtype."""
    bk, _ = cfg.array_size
    spec = cfg.input_spec
    xp = _pad_to(x.to(torch.float32), 1, bk)
    m, kp = xp.shape
    xb = xp.reshape(m, kp // bk, bk)
    sxs = block_scale(xb.abs().amax(dim=2), spec)
    xq = quantize(xb, sxs[:, :, None], spec)
    return (
        (xq.to(torch.float32) * sxs[:, :, None])
        .to(_store_dtype(cfg))
        .reshape(m, kp)
    )


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the reference's dtype rule: bf16 operands are
    multiplied with float32 accumulation and the product rounded to
    bf16 (the same on every device)."""
    if a.dtype == torch.bfloat16:
        return (a.float() @ b.float()).to(torch.bfloat16)
    return a @ b


def resolve_backend(cfg: DPEConfig) -> str:
    """Concrete engine for ``cfg``: ``"fused"`` (the fused sliced matmul
    of :mod:`repro_torch.kernels.ops`, which picks the kernel or its
    plain version by tensor device) for faithful layers on ``auto`` /
    ``pallas``, else ``"xla"`` (the plain vectorized engines)."""
    if cfg.backend == "circuit":
        raise NotImplementedError(
            "the circuit backend is not ported to repro_torch yet"
        )
    if cfg.mode == "faithful" and cfg.backend in ("auto", "pallas"):
        return "fused"
    return "xla"


def dpe_matmul_prepared(
    x: torch.Tensor,
    pw: PreparedWeight,
    n: int,
    cfg: DPEConfig,
    kernels: bool = True,
) -> torch.Tensor:
    """``x @ w`` through an already-programmed weight (any leading dims).
    ``kernels=False`` is the explicit plain-version override."""
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1])
    if resolve_backend(cfg) == "fused":
        y = _kops.fused_sliced_matmul(
            xm.to(torch.float32), pw.slices, pw.scale,
            input_spec=cfg.input_spec, weight_spec=cfg.weight_spec,
            array_size=cfg.array_size, rdac=cfg.rdac, radc=cfg.radc,
            adc_mode=cfg.adc_mode, kernels=kernels,
        )
        return y[:, :n].reshape(*lead, n)
    xs, sx = prepare_input(xm, cfg)
    if cfg.mode == "faithful":
        y = _faithful_matmul(xs, sx, pw.slices, pw.scale, cfg)
    else:
        y = _fast_matmul(xs, sx, pw.slices, pw.scale, cfg)
    return y[:, :n].reshape(*lead, n)


def dpe_matmul_folded(
    x: torch.Tensor, fw: FoldedWeight, n: int, cfg: DPEConfig
) -> torch.Tensor:
    """Fast-mode ``x @ w`` through an already-folded noisy weight.
    ``FoldedWeight`` is a plain product (no kernel)."""
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1])
    x_deq = fake_quant_input(xm, cfg).to(fw.w_eff.dtype)
    y = _dot(x_deq, fw.w_eff)[:, :n]
    return y.reshape(*lead, n).to(torch.float32)


def program_weight(
    w: torch.Tensor,
    cfg: DPEConfig | None,
    key: int | None = None,
    t_prog: float | None = None,
) -> PreparedWeight | FoldedWeight | None:
    """Program one weight matrix for ``cfg``'s mode: ``PreparedWeight``
    (faithful), ``FoldedWeight`` (fast) or ``None`` (digital).
    Programming is a pure function of ``(w, cfg, key)``."""
    if cfg is None or cfg.mode == "digital":
        return None
    if cfg.mode == "fast":
        return FoldedWeight(fold_weight_noisy(w, cfg, key), t_prog=t_prog)
    return prepare_weight(w, cfg, key)._replace(t_prog=t_prog)


def dpe_apply(
    x: torch.Tensor,
    prog: PreparedWeight | FoldedWeight,
    n: int,
    cfg: DPEConfig,
    kernels: bool = True,
) -> torch.Tensor:
    """``x @ w`` through programmed state from :func:`program_weight`."""
    if isinstance(prog, FoldedWeight):
        return dpe_matmul_folded(x, prog, n, cfg)
    return dpe_matmul_prepared(x, prog, n, cfg, kernels)


def dpe_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg: DPEConfig,
    key: int | None = None,
    kernels: bool = True,
) -> torch.Tensor:
    """End-to-end simulated ``x @ w`` (programs the weight on the fly)."""
    if cfg.mode == "digital":
        return x.to(torch.float32) @ w.to(torch.float32)
    return dpe_apply(x, program_weight(w, cfg, key), w.shape[1], cfg, kernels)
