"""Variable-precision bit-sliced dot-product engine — MemIntelli §3.3
(port of ``repro/core/dpe.py``).

``y ≈ x @ w``: the weight is tiled into ``array_size = (bk, bn)``
crossbar tiles, quantised per block, bit-sliced and programmed with
log-normal noise; the input is quantised per (row, K-block), sliced and
DAC'd; every (input-slice x weight-slice) pair is one analog matmul per
K-block whose bit-line current is ADC-quantised; partial sums are
recombined digitally.  Modes: ``faithful`` (paper semantics), ``fast``
(digital slice folding, exact when the ADC is ideal) and ``digital``.

Faithful layers go through the fused sliced matmul of
:mod:`repro_torch.kernels.ops` — the hand-written CUDA kernel on a CUDA
tensor, its plain version on the CPU.  The backend sets the row tile of
the ``dynamic`` ADC range: the whole call for ``xla`` (the reference's
vectorized engine), 128 rows for ``auto`` / ``pallas`` (its kernel).
The ``circuit`` backend solves every slice-pair crossbar operation
through the IR-drop circuit model (:func:`_circuit_matmul`,
:mod:`.crossbar`), plain PyTorch on either device.
:func:`_faithful_matmul` is the vectorized plain engine and
:func:`_faithful_matmul_loop` the seed slice-pair loop, kept verbatim;
the tests hold the engines against each other and the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops as _kops

from .crossbar import solve_crossbar
from .device import slice_to_conductance
from .drift import drift_now
from .engine import DPEConfig
from .quant import adc_quantize, block_scale, dac_quantize, div, quantize
from .prng import fold_in
from .slicing import slice_int, slice_significances

__all__ = [
    "PreparedWeight",
    "FoldedWeight",
    "prepare_weight",
    "prepare_input",
    "program_weight",
    "program_stack",
    "dpe_matmul",
    "dpe_matmul_prepared",
    "dpe_matmul_folded",
    "dpe_apply",
    "resolve_backend",
    "relative_error",
]


class PreparedWeight(NamedTuple):
    """A weight matrix programmed onto (simulated) crossbar tiles.

    slices: (Sw, Kp, Np) float32 — noisy slice values (analog domain).
    scale:  (nk, nn)     float32 — per-block quant / pre-alignment scale.
    t_prog: device-clock programming time, the drift reference (None:
            untimed state, which never drifts).
    """

    slices: torch.Tensor
    scale: torch.Tensor
    t_prog: float | None = None


class FoldedWeight(NamedTuple):
    """Fast-mode programmed state: the digitally folded noisy effective
    weight (Kp, Np) in ``cfg.store_dtype``; ``t_prog`` as on
    :class:`PreparedWeight`."""

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
    w: torch.Tensor, cfg: DPEConfig, key=None, kernels: bool = True
) -> PreparedWeight:
    """Quantise, slice and 'program' a weight matrix (the paper's
    ``update_weight()``).  ``key`` (a :mod:`~repro_torch.core.prng` key)
    drives programming noise (slice ``s`` draws with ``fold_in(key, s)``,
    through :func:`repro_torch.kernels.ops.program_noise`, whose plain
    version ``kernels=False`` picks); None means ideal devices.  The
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
            v = _kops.program_noise(
                fold_in(key, s), v, bits=width, hgs=cfg.hgs, lgs=cfg.lgs, cv=cfg.cv,
                kernels=kernels,
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
    w: torch.Tensor, cfg: DPEConfig, key=None, kernels: bool = True
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
            v = _kops.program_noise(
                fold_in(key, s), v, bits=width, hgs=cfg.hgs, lgs=cfg.lgs, cv=cfg.cv,
                kernels=kernels,
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


V_READ = 0.2  # word-line read voltage at full scale (V)


def _circuit_matmul(xs, sx, ws, sw, cfg: DPEConfig) -> torch.Tensor:
    """Every slice-pair crossbar operation solved through the IR-drop
    circuit model instead of the ideal dot product: slice values map to
    word-line voltages (``V_READ`` at full scale) and conductances, each
    physical (bk x bn) tile of each K-block is solved for every input row
    (:func:`~repro_torch.core.crossbar.solve_crossbar`, 2.93 Ω, 20
    sweeps), the sensed bit-line currents go back to slice units (the
    conductance offset ``LGS`` removed) and are recombined digitally.
    No ADC: the reference's circuit path has none.

    xs: (Sx, M, Kp); sx: (M, nk); ws: (Sw, Kp, Np); sw: (nk, nn).
    Returns (M, Np) float32."""
    bk, bn = cfg.array_size
    sxn, m, kp = xs.shape
    swn, _, np_ = ws.shape
    nk, nn = kp // bk, np_ // bn
    sigx = slice_significances(cfg.input_spec)
    sigw = slice_significances(cfg.weight_spec)
    # (nk, M, Np): rows carry sx, columns sw repeated over a tile's bit lines
    kb_scale = sx.t()[:, :, None] * torch.repeat_interleave(sw, bn, dim=1)[:, None, :]
    out = torch.zeros((m, np_), dtype=torch.float32, device=xs.device)
    for i in range(sxn):
        vmax_x = 2.0 ** cfg.input_spec.bits[i] - 1.0
        # every K-block at once: (nk, M, bk) word-line voltages
        vin = div(xs[i].reshape(m, nk, bk).permute(1, 0, 2), vmax_x) * V_READ
        col_sum = (div(vin, V_READ) * vmax_x).sum(dim=2, keepdim=True)  # (nk, M, 1)
        for j in range(swn):
            bits_w = cfg.weight_spec.bits[j]
            dg = (cfg.hgs - cfg.lgs) / (2.0**bits_w - 1.0)
            # one physical tile per (K-block, N-block): word-line IR-drop
            # does not span separate arrays
            g_tiles = slice_to_conductance(
                ws[j].reshape(nk, bk, nn, bn).permute(0, 2, 1, 3), bits_w, cfg.hgs, cfg.lgs,
            )  # (nk, nn, bk, bn)
            res = solve_crossbar(g_tiles[:, :, None], vin[:, None], 2.93, 20).i_out
            # (nk, nn, M, bn) -> (nk, M, Np), back to slice units
            y = div(res.permute(0, 2, 1, 3).reshape(nk, m, np_), V_READ) * vmax_x
            # remove the conductance offset: I = V (LGS + v_w dg)
            y = div(y - col_sum * cfg.lgs, dg)
            pair = (y * kb_scale).sum(dim=0)
            out = out + float(sigx[i] * sigw[j]) * pair
    return out


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the reference's dtype rule: bf16 operands are
    multiplied with float32 accumulation and the product rounded to
    bf16 (the same on every device)."""
    if a.dtype == torch.bfloat16:
        return (a.float() @ b.float()).to(torch.bfloat16)
    return a @ b


def resolve_backend(cfg: DPEConfig) -> str:
    """Concrete engine for ``cfg``: ``"circuit"`` (the IR-drop circuit
    model) when asked for, else ``"fused"`` (the fused sliced matmul of
    :mod:`repro_torch.kernels.ops`, which picks the kernel or its plain
    version by tensor device) for faithful layers and ``"xla"`` (the
    plain vectorized engines) for the others."""
    if cfg.backend == "circuit":
        return "circuit"
    return "fused" if cfg.mode == "faithful" else "xla"


def range_rows(cfg: DPEConfig, m: int) -> int:
    """Rows that share one ``dynamic`` ADC range in a fused call of ``m``
    rows: all of them for ``xla`` (the reference's vectorized engine
    ranges over the whole call), 128 for ``auto`` / ``pallas`` (the
    reference kernel's row tile)."""
    return 128 if cfg.backend in ("auto", "pallas") else max(m, 1)


def _drift_factor(cfg: DPEConfig, t_prog, t_now=None):
    """The float32 decay factor of state programmed at ``t_prog`` and
    read at ``t_now`` (default: the published :func:`drift_now`), or
    None where drift does not apply (no model, untimed state, no clock):
    then nothing is multiplied, so drift off is bitwise off."""
    if cfg.drift is None or t_prog is None:
        return None
    if t_now is None:
        t_now = drift_now()
    if t_now is None:
        return None
    return cfg.drift.factor(np.float32(t_now) - np.float32(t_prog))


def dpe_matmul_prepared(
    x: torch.Tensor,
    pw: PreparedWeight,
    n: int,
    cfg: DPEConfig,
    kernels: bool = True,
    t_now=None,
) -> torch.Tensor:
    """``x @ w`` through an already-programmed weight (any leading dims).
    Drift multiplies every slice value by its factor before the analog
    products: inside K1 as the slices are read, or on the slice stack for
    the plain engine.  ``kernels=False`` is the explicit plain-version
    override.  An expert stack (slices (E, Sw, Kp, Np), scales (E, nk, nn),
    one ``t_prog``) takes x (E, M, K) to (E, M, n), each expert as a call
    of its own (the reference's ``vmap`` over the expert axis): one K1
    launch, ``dynamic`` ranges over each expert's rows; the circuit
    backend solves expert by expert."""
    stack = pw.slices.dim() == 4
    lead = x.shape[:-1]
    xm = x if stack else x.reshape(-1, x.shape[-1])
    f = _drift_factor(cfg, pw.t_prog, t_now)
    backend = resolve_backend(cfg)
    if backend == "fused":
        y = _kops.fused_sliced_matmul(
            xm.to(torch.float32), pw.slices, pw.scale,
            input_spec=cfg.input_spec, weight_spec=cfg.weight_spec,
            array_size=cfg.array_size, rdac=cfg.rdac, radc=cfg.radc,
            adc_mode=cfg.adc_mode, bm=range_rows(cfg, xm.shape[-2]),
            drift=1.0 if f is None else f, kernels=kernels,
        )
        return y[..., :n].reshape(*lead, n)
    if stack:
        return torch.stack([
            dpe_matmul_prepared(x[i], PreparedWeight(pw.slices[i], pw.scale[i], pw.t_prog),
                                n, cfg, kernels, t_now)
            for i in range(x.shape[0])
        ])
    slices = pw.slices if f is None else pw.slices * torch.tensor(f, device=x.device)
    xs, sx = prepare_input(xm, cfg)
    if backend == "circuit":
        y = _circuit_matmul(xs, sx, slices, pw.scale, cfg)
    else:
        y = _fast_matmul(xs, sx, slices, pw.scale, cfg)
    return y[:, :n].reshape(*lead, n)


def dpe_matmul_folded(
    x: torch.Tensor, fw: FoldedWeight, n: int, cfg: DPEConfig, t_now=None
) -> torch.Tensor:
    """Fast-mode ``x @ w`` through an already-folded noisy weight; drift
    scales ``w_eff`` in its store dtype (the fold is linear in the slice
    values).  ``FoldedWeight`` is a plain product (no kernel); a stack's
    ``w_eff`` (E, Kp, Np) takes x (E, M, K) in one batched product."""
    lead = x.shape[:-1]
    xm = x.reshape(-1, x.shape[-1])
    w_eff = fw.w_eff
    f = _drift_factor(cfg, fw.t_prog, t_now)
    if f is not None:
        w_eff = w_eff * torch.tensor(f, device=x.device).to(w_eff.dtype)
    x_deq = fake_quant_input(xm, cfg).to(w_eff.dtype)
    if w_eff.dim() == 3:
        x_deq = x_deq.reshape(w_eff.shape[0], -1, x_deq.shape[-1])
    y = _dot(x_deq, w_eff)[..., :n]
    return y.reshape(*lead, n).to(torch.float32)


def program_weight(
    w: torch.Tensor,
    cfg: DPEConfig | None,
    key=None,
    t_prog: float | None = None,
    kernels: bool = True,
) -> PreparedWeight | FoldedWeight | None:
    """Program one weight matrix for ``cfg``'s mode: ``PreparedWeight``
    (faithful), ``FoldedWeight`` (fast) or ``None`` (digital), stamped
    with the device-clock time ``t_prog`` (the drift reference).
    Programming is a pure function of ``(w, cfg, key)``."""
    if cfg is None or cfg.mode == "digital":
        return None
    if cfg.mode == "fast":
        return FoldedWeight(fold_weight_noisy(w, cfg, key, kernels), t_prog=t_prog)
    return prepare_weight(w, cfg, key, kernels)._replace(t_prog=t_prog)


def program_stack(
    w: torch.Tensor,
    cfg: DPEConfig,
    key,
    base: int = 0,
    t_prog: float | None = None,
    kernels: bool = True,
) -> PreparedWeight | FoldedWeight:
    """Program a weight stack w (E, K, N) for ``cfg`` (faithful or fast),
    expert ``i`` with the key ``fold_in(key, base + i)``: one
    preallocated (E, ...) tensor per part, written an expert at a time,
    each expert's programming freed before the next."""
    stack = None
    for i in range(w.shape[0]):
        pw = program_weight(w[i], cfg, fold_in(key, base + i), t_prog, kernels)
        parts = (pw.w_eff,) if isinstance(pw, FoldedWeight) else (pw.slices, pw.scale)
        if stack is None:
            stack = [torch.empty((w.shape[0],) + tuple(t.shape), dtype=t.dtype, device=t.device)
                     for t in parts]
        for dst, src in zip(stack, parts):
            dst[i].copy_(src)
        del pw, parts
    if len(stack) == 1:
        return FoldedWeight(stack[0], t_prog)
    return PreparedWeight(stack[0], stack[1], t_prog)


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
    key=None,
    kernels: bool = True,
) -> torch.Tensor:
    """End-to-end simulated ``x @ w`` (programs the weight on the fly)."""
    if cfg.mode == "digital":
        return x.to(torch.float32) @ w.to(torch.float32)
    return dpe_apply(x, program_weight(w, cfg, key, kernels=kernels), w.shape[1], cfg, kernels)


def relative_error(sim: torch.Tensor, ideal: torch.Tensor) -> torch.Tensor:
    """Paper's RE metric: ``||sim - ideal||_2 / ||ideal||_2`` (0-d)."""
    return torch.linalg.norm(sim - ideal) / torch.clamp_min(torch.linalg.norm(ideal), 1e-30)
