"""K1 and K4 — the faithful DPE matmul: CUDA kernels and plain versions.

K1, the fused kernel, replaces
``repro/kernels/sliced_matmul.py::fused_sliced_matmul_pallas``
(``pallas_call`` at :352; body ``_fused_kernel`` :246 with
``_prep_input_tile`` :208 and ``_adc`` :69).  One call runs, per
(row, K-block): absmax quantisation, two's-complement bit-slicing and the
DAC of the raw activations; then every Sx·Sw slice-pair dot, the per-pair
ADC (``dynamic`` over a logical ``bm``-row tile, ``dynamic_row`` per row,
``fullscale`` static) and ``round(p/step)·step``; then the recombination
by ``sigx·sigw`` and the block scales ``sx·sw``; K-blocks summed in order.

K4, the staged kernel, replaces ``sliced_matmul_pallas`` (``pallas_call``
at :185; body ``_kernel`` :90): the same product on inputs already
sliced and DAC'd by ``core.dpe.prepare_input`` (``xs``, ``sx``).  Its
plain version is ``kernels/ref.py::sliced_matmul_ref``.

Kernels (``csrc/sliced_matmul.cuh``, one source per crossbar tile size
``bk = bn`` ∈ {32, 64, 128}): one block owns the bit-lines (columns) of
one n-block for one K-block and a few rows, so the ``dynamic_row`` range
is a block-local reduction; the input rows are prepared (K1) or copied
(K4) into shared memory; four groups of ``bn`` threads each stream one
weight slice's columns at once (so a block keeps four loads per column
in flight, not one chain) and keep the Sx×rows partial sums in
registers, one in-order fused multiply-add chain per partial sum; the
quantised pair results are recombined in the reference order.
K-blocks run in parallel blocks that write per-K-block partials; a
second small kernel adds them in K order starting from zero — the
reference's sequential accumulator, so the split changes no rounding.
The M tail is masked, not padded; ``dynamic`` mode walks the whole
logical ``bm``-row tile in one block (two passes: range, then quantise),
for K1 at any ``bm`` (the default backend passes ``bm = M``), for K4 at
``bm`` ∈ {32, 64, 128}.
Rows per sub-chunk drop from 8 to 4 when Sx·Sw > 36, so the quantised
pair buffer of every preset fits a block's shared memory.

Bound on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32 without tensor cores):
decode (M ≤ slots) reads every programmed slice once — 16 B per weight
(4 f32 slices), 7.9 GB per qwen2-0.5b decode step, 2.4 ms — so it is
bytes-bound; a 32-token prefill chunk does 16·2·M·K·N ≈ 0.37 TFLOP of
f32 work over the 24 layers, 5.5 ms, operations-bound (the vocab head
runs on the final chunk's last token only).  K4 at the paper's Table 2
shape (M, K, N = 128, 1024, 1024, int8, 64×64) does 16·2·M·K·N = 4.3
GFLOP over 18.5 MB: operations-bound.  The kernels use CUDA-core f32
FMAs (noisy slices are not integers, so a bf16/TF32 tensor-core dot
would not be exact) and no TMA/wgmma; making them fast is later work.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.quant import div
from repro_torch.core.slicing import SliceSpec, slice_significances

from .build import LaunchCounter, check, library
from .ref import sliced_matmul_ref

__all__ = [
    "fused_sliced_matmul_ref",
    "fused_sliced_matmul_cuda",
    "staged_sliced_matmul_cuda",
    "counter",
    "staged_counter",
]

_EPS = 1e-30
TILES = (32, 64, 128)  # square crossbar tiles bk = bn the kernels take
INPUT_SLICES = (3, 4, 5, 6, 8)  # input slice counts the kernels are built for
MAX_SLICES = 8
counter = LaunchCounter("fused_sliced_matmul")
staged_counter = LaunchCounter("sliced_matmul")


def _prep_input(x: torch.Tensor, spec: SliceSpec, bk: int, rdac: int):
    """Plain ``_prep_input_tile`` over every (row, K-block) of a
    K-padded (M, Kp) input: per-row absmax -> block scale -> round/clip
    -> two's-complement slices -> per-slice DAC.  Returns the DAC'd
    slices (Sx, M, Kp) and the scales (M, nk)."""
    m, kp = x.shape
    xb = x.reshape(m, kp // bk, bk)
    absmax = torch.clamp_min(xb.abs().amax(dim=2, keepdim=True), _EPS)
    b = spec.total_bits
    if spec.kind == "int":
        levels = 2.0 ** (b - 1) - 1.0 if spec.signed else 2.0**b - 1.0
        sx = div(absmax, levels)
    else:
        sx = torch.exp2(torch.floor(torch.log2(absmax)) - (b - 2))
    xq = torch.clamp(torch.round(xb / sx), spec.qmin, spec.qmax).to(torch.int32)
    u = torch.bitwise_and(xq, (1 << b) - 1)
    slices = []
    for width, off in zip(spec.bits, spec.lsb_offsets):
        v = torch.bitwise_and(
            torch.bitwise_right_shift(u, off), (1 << width) - 1
        ).to(torch.float32)
        vmax = float(2**width - 1)
        if rdac > 1 and (rdac - 1) % max(int(vmax), 1) != 0:
            dstep = vmax / (rdac - 1)
            v = torch.round(div(v, dstep)) * dstep
        slices.append(v.reshape(m, kp))
    return torch.stack(slices, dim=0), sx[:, :, 0]


def fused_sliced_matmul_ref(
    x: torch.Tensor,  # (M, K) raw float input, K <= Kp
    ws: torch.Tensor,  # (Sw, Kp, Np)
    sw: torch.Tensor,  # (nk, nn)
    *,
    input_spec: SliceSpec,
    weight_spec: SliceSpec,
    array_size: tuple[int, int],
    rdac: int,
    radc: int,
    adc_mode: str,
    bm: int = 128,
) -> torch.Tensor:
    """Plain version of the fused kernel (K zero-padded to Kp).  Only
    ``dynamic`` ranging depends on the row tiling: there M is padded with
    zero rows to whole ``bm`` tiles, as the reference wrapper does; the
    row-independent modes need no padding.  Returns (M, Np) float32."""
    bk, _ = array_size
    m, k = x.shape
    kp = ws.shape[1]
    if k > kp or kp - k >= bk:
        raise ValueError(f"K={k} inconsistent with prepared Kp={kp}")
    if m == 0:
        return x.new_zeros((0, ws.shape[2]), dtype=torch.float32)
    tiled = adc_mode == "dynamic" and radc > 1
    padm = (-m) % bm if tiled else 0
    x = torch.nn.functional.pad(x.to(torch.float32), (0, kp - k, 0, padm))
    xs, sx = _prep_input(x, input_spec, bk, rdac)
    y = sliced_matmul_ref(
        xs, sx, ws, sw, input_spec=input_spec, weight_spec=weight_spec,
        array_size=array_size, radc=radc, adc_mode=adc_mode,
        bm=bm if tiled else m,
    )
    return y[:m]


@functools.lru_cache(maxsize=None)
def _spec_arrays(input_spec, weight_spec, rdac, radc, adc_mode, bk):
    """Pack the static slicing/converter parameters for the C entry
    (read-only arrays, cached per configuration)."""
    ints = np.zeros(8 + 3 * MAX_SLICES, np.int32)
    floats = np.zeros(2 + MAX_SLICES + 2 * MAX_SLICES * MAX_SLICES, np.float32)
    sx_n, sw_n = input_spec.n_slices, weight_spec.n_slices
    b = input_spec.total_bits
    ints[:8] = [
        sx_n, sw_n, b, int(input_spec.kind == "fp"), input_spec.qmin,
        input_spec.qmax, radc,
        {"dynamic": 0, "dynamic_row": 1, "fullscale": 2}[adc_mode],
    ]
    levels = 2.0 ** (b - 1) - 1.0 if input_spec.signed else 2.0**b - 1.0
    floats[0] = np.float32(levels)
    floats[1] = np.float32(radc - 1)
    for i, (width, off) in enumerate(zip(input_spec.bits, input_spec.lsb_offsets)):
        vmax = float(2**width - 1)
        ints[8 + i] = off
        ints[8 + MAX_SLICES + i] = width
        dac = rdac > 1 and (rdac - 1) % max(int(vmax), 1) != 0
        ints[8 + 2 * MAX_SLICES + i] = int(dac)
        floats[2 + i] = np.float32(vmax / (rdac - 1)) if dac else 0.0
    sigx = slice_significances(input_spec)
    sigw = slice_significances(weight_spec)
    base = 2 + MAX_SLICES
    for i in range(sx_n):
        for j in range(sw_n):
            floats[base + i * MAX_SLICES + j] = np.float32(sigx[i] * sigw[j])
            floats[base + MAX_SLICES * MAX_SLICES + i * MAX_SLICES + j] = (
                np.float32(
                    bk * (2.0 ** input_spec.bits[i] - 1.0)
                    * (2.0 ** weight_spec.bits[j] - 1.0)
                )
            )
    ints.flags.writeable = False
    floats.flags.writeable = False
    return ints, floats


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(library(), name)
    fn.restype = ctypes.c_int
    head = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]  # x, ldx, M, K
        if name == "fused_sliced_matmul_launch"
        else [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]  # xs, sx, M
    )
    fn.argtypes = head + [
        ctypes.c_void_p, ctypes.c_void_p,  # ws, sw
        ctypes.c_void_p, ctypes.c_void_p,  # part, out
        ctypes.c_int, ctypes.c_int,  # Kp, Np
        ctypes.c_int, ctypes.c_int,  # tile, bm
        ctypes.c_void_p, ctypes.c_void_p,  # host int / float params
        ctypes.c_void_p,  # stream
    ]
    return fn


def _need(who: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{who}: {msg}")


def _check_weights(who, ws, sw, input_spec, weight_spec, array_size, adc_mode, tensors):
    """Validate what both kernels take; returns ``(tile, nk, kp, np_)``."""
    for name, t in tensors:
        _need(who, t.is_cuda, f"{name} must be a CUDA tensor")
        _need(who, t.dtype == torch.float32, f"{name} must be float32")
        _need(who, t.is_contiguous(), f"{name} must be contiguous")
        _need(who, t.device == ws.device, f"{name} is on another device")
    bk, bn = array_size
    _need(who, bk == bn and bk in TILES,
          f"array_size {tuple(array_size)} is not a square tile of {TILES}")
    _need(who, ws.dim() == 3 and sw.dim() == 2, "bad ranks")
    swn, kp, np_ = ws.shape
    _need(who, kp % bk == 0 and np_ % bk == 0, "Kp/Np not tile multiples")
    nk, nn = kp // bk, np_ // bk
    _need(who, tuple(sw.shape) == (nk, nn), f"sw shape {tuple(sw.shape)} != {(nk, nn)}")
    _need(who, swn == weight_spec.n_slices, "ws slice count != weight_spec")
    _need(who, input_spec.n_slices in INPUT_SLICES,
          f"{input_spec.n_slices} input slices; the kernels take {INPUT_SLICES}")
    _need(who, swn <= MAX_SLICES, f"more than {MAX_SLICES} weight slices")
    _need(who, adc_mode in ("dynamic", "dynamic_row", "fullscale"), f"bad adc_mode {adc_mode!r}")
    return bk, nk, kp, np_


def _launch(name, lead, m, ws, sw, kp, np_, tile, bm, params, device):
    out = torch.empty((m, np_), dtype=torch.float32, device=device)
    if m == 0:
        return out
    part = torch.empty((kp // tile, m, np_), dtype=torch.float32, device=device)
    ints, floats = params
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _entry(name)(
            *lead, ws.data_ptr(), sw.data_ptr(), part.data_ptr(), out.data_ptr(),
            kp, np_, tile, bm, ints.ctypes.data, floats.ctypes.data, stream,
        )
    check(rc, name)
    return out


def fused_sliced_matmul_cuda(
    x: torch.Tensor,
    ws: torch.Tensor,
    sw: torch.Tensor,
    *,
    input_spec: SliceSpec,
    weight_spec: SliceSpec,
    array_size: tuple[int, int],
    rdac: int,
    radc: int,
    adc_mode: str,
    bm: int = 128,
) -> torch.Tensor:
    """Launch K1 on the card: x (M, K) float32 raw activations, ws
    (Sw, Kp, Np) float32 programmed slices, sw (nk, nn) float32 block
    scales -> (M, Np) float32; ``bm`` rows share a ``dynamic`` range
    (any ``bm >= 1``: ``bm >= M`` is one range over the whole call).
    Raises on anything the kernel does not take (it never falls back to
    the plain version)."""
    who = "fused_sliced_matmul_cuda"
    tile, nk, kp, np_ = _check_weights(
        who, ws, sw, input_spec, weight_spec, array_size, adc_mode,
        (("x", x), ("ws", ws), ("sw", sw)),
    )
    _need(who, bm >= 1, f"bm={bm} must be positive")
    _need(who, x.dim() == 2, "x must be 2-D")
    m, k = x.shape
    _need(who, k <= kp and kp - k < tile, f"K={k} inconsistent with Kp={kp}")
    params = _spec_arrays(input_spec, weight_spec, rdac, radc, adc_mode, tile)
    out = _launch("fused_sliced_matmul_launch", (x.data_ptr(), k, m, k), m, ws, sw,
                  kp, np_, tile, bm, params, x.device)
    if m:
        counter.count += 1
    return out


def staged_sliced_matmul_cuda(
    xs: torch.Tensor,
    sx: torch.Tensor,
    ws: torch.Tensor,
    sw: torch.Tensor,
    *,
    input_spec: SliceSpec,
    weight_spec: SliceSpec,
    array_size: tuple[int, int],
    radc: int,
    adc_mode: str,
    bm: int = 128,
) -> torch.Tensor:
    """Launch K4 on the card: xs (Sx, M, Kp) DAC'd input slices and sx
    (M, nk) input scales from ``prepare_input``, ws / sw as for K1; M a
    multiple of ``bm`` (``ops.sliced_matmul`` pads).  Returns (M, Np)
    float32."""
    who = "staged_sliced_matmul_cuda"
    tile, nk, kp, np_ = _check_weights(
        who, ws, sw, input_spec, weight_spec, array_size, adc_mode,
        (("xs", xs), ("sx", sx), ("ws", ws), ("sw", sw)),
    )
    _need(who, bm in TILES, f"bm={bm} is not one of {TILES}")
    _need(who, xs.dim() == 3 and sx.dim() == 2, "xs must be 3-D and sx 2-D")
    sxn, m, kx = xs.shape
    _need(who, sxn == input_spec.n_slices, "xs slice count != input_spec")
    _need(who, kx == kp, f"xs has Kp={kx}, the weights {kp}")
    _need(who, tuple(sx.shape) == (m, nk), f"sx shape {tuple(sx.shape)} != {(m, nk)}")
    _need(who, m % bm == 0, f"M={m} is not a multiple of bm={bm}")
    params = _spec_arrays(input_spec, weight_spec, 0, radc, adc_mode, tile)
    out = _launch("staged_sliced_matmul_launch", (xs.data_ptr(), sx.data_ptr(), m), m,
                  ws, sw, kp, np_, tile, bm, params, xs.device)
    if m:
        staged_counter.count += 1
    return out
