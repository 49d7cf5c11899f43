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
``bk = bn`` ∈ {32, 64, 128}), one launch per call: a tile (n-block,
K-block) runs on Sw × S_c CTAs, one per weight slice and column slab; a
CTA streams its slab into shared memory by TMA, prepares its rows'
inputs (K1) or copies them (K4), and runs its slice-pair chains, each one
in-order fused multiply-add chain over the crossbar rows.  At decode
(M ≤ 4) the tile's pair sums go through device memory to the tile's last
CTA, which ranges, quantises and recombines them; otherwise the tile's
CTAs form a thread block cluster that exchanges the ADC maxima and the
quantised pairs through distributed shared memory.  K-blocks are added in
K order from zero by the last CTA of each output block (an atomic
ticket) — the reference's sequential accumulator, so the split changes
no rounding.  ``dynamic`` ranges over whole ``bm``-row tiles; a tile
larger than a CTA's row unit takes a range pass and a quantise pass.
:func:`plan_k1` computes the launch geometry (checked by the C entry).

Bound on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32 without tensor cores):
decode (M ≤ slots) reads every programmed slice once — 16 B per weight
(4 f32 slices), 7.9 GB per qwen2-0.5b decode step, 2.4 ms — so it is
bytes-bound; a 32-token prefill chunk does 16·2·M·K·N ≈ 0.37 TFLOP of
f32 work over the 24 layers, 5.5 ms, operations-bound (the vocab head
runs on the final chunk's last token only).  K4 at the paper's Table 2
shape (M, K, N = 128, 1024, 1024, int8, 64×64) does 16·2·M·K·N = 4.3
GFLOP over 18.5 MB: operations-bound.  The chains use CUDA-core f32
FMAs: noisy slices are not integers, so a bf16/TF32 tensor-core dot
would not be exact.  Each CTA is a chain of latencies (TMA arrival,
chains, the tile's epilogue) and shared memory caps the CTAs in flight,
which is what keeps the kernel from its bounds (PERF.md).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.quant import div
from repro_torch.core.slicing import SliceSpec, slice_significances

from .build import LaunchCounter, check, library
from .ref import sliced_matmul_ref

__all__ = [
    "K1Plan",
    "plan_k1",
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
    drift: float = 1.0,
) -> torch.Tensor:
    """Plain version of the fused kernel (K zero-padded to Kp), on the
    slices times the float32 ``drift`` factor.  Only
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
    if drift != 1.0:
        ws = ws * torch.tensor(np.float32(drift), device=ws.device)
    y = sliced_matmul_ref(
        xs, sx, ws, sw, input_spec=input_spec, weight_spec=weight_spec,
        array_size=array_size, radc=radc, adc_mode=adc_mode,
        bm=bm if tiled else m,
    )
    return y[:m]


@functools.lru_cache(maxsize=None)
def _spec_arrays(input_spec, weight_spec, rdac, radc, adc_mode, bk):
    """Pack the static slicing/converter parameters for the C entry
    (read-only arrays, cached per configuration): ``(ints address, floats
    address, ints, floats)``."""
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
    # the C entry reads them by address; the cached tuple keeps them alive
    return ints.ctypes.data, floats.ctypes.data, ints, floats


SMEM_MAX = 232_448  # bytes of shared memory a block may have on an H100
MAX_THREADS = 512
MAX_CLUSTER = 8  # the portable thread block cluster size
TARGET_CTAS = 264  # two CTAs for each of the H100's 132 SMs
UNIT_ROWS = 32  # rows a unit holds, unless a `dynamic` tile needs more
GX_THREADS = 128  # threads of a decode-exchange CTA


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """Launch geometry of one K1 / K4 call (``csrc/sliced_matmul.cuh``).

    A crossbar tile (n-block, K-block) runs on ``csize = Sw * sc`` CTAs:
    CTA (slab, jw) owns weight slice jw of a ``T / sc`` column slab.  A
    CTA holds ``mr`` rows (a row unit) and loops over ``upc`` units; grid
    ``(nn * csize, nk, z)``.  ``dynamic`` ranges over ``bmr``-row tiles
    of ``upt`` units each; a tile of more than one unit takes a range
    pass and a quantise pass (``two_pass``).  At decode (``gx``) the
    tile's CTAs hand their pair sums to the tile's last CTA through
    device memory; otherwise they form a thread block cluster."""

    sc: int
    cw: int
    rw: int
    nwr: int
    mr: int
    xs: int
    units: int
    upt: int
    bmr: int
    upc: int
    z: int
    two_pass: int
    smem: int
    threads: int
    gx: int
    csize: int
    nn: int
    nk: int
    sx_n: int
    sw_n: int
    tile: int

    @property
    def ctas(self) -> int:
        """CTAs a call launches (over both passes)."""
        return self.nn * self.nk * self.csize * self.z * self.launches

    @property
    def launches(self) -> int:
        return 2 if self.two_pass else 1

    @property
    def tickets(self) -> int:
        if self.gx:  # a ticket per tile, then one per (z, n-block)
            return self.z * self.nn * (self.nk + 1)
        return self.z * self.nn * self.csize

    @property
    def scratch_floats(self) -> int:
        """Device scratch: the tiles' pairs (``gx``) or the range pass's
        maxima (``two_pass``)."""
        if self.gx:
            return self.z * self.nk * self.nn * self.sx_n * self.mr * self.sw_n * self.tile
        if self.two_pass:
            return self.units * self.nk * self.nn * self.csize * self.sx_n
        return 0

    @functools.cached_property
    def ints(self) -> np.ndarray:
        a = np.array([self.sc, self.cw, self.rw, self.nwr, self.mr, self.xs, self.units,
                      self.upt, self.bmr, self.upc, self.z, self.two_pass, self.smem,
                      self.threads, self.gx], np.int32)
        a.flags.writeable = False
        return a

    @functools.cached_property
    def ints_ptr(self) -> int:
        """Address of :attr:`ints` for the C entry (the plans are cached)."""
        return self.ints.ctypes.data


def _geometry(rows: int, tile: int, sc: int, sx_n: int):
    """(rw, nwr, mr, xs, threads, smem) for a unit of ``rows`` rows."""
    c = tile // sc
    cw = 1 if c == 32 else 2
    nwc = c // (32 * cw)
    rw = 2 if rows <= 4 else 4
    nwr = -(-rows // rw)
    mr = rw * nwr
    xs = -(-(mr * sx_n) // 4) * 4
    if xs % 32 == 0:  # lanes (k) write rows xs apart: keep them off one bank
        xs += 4
    floats = tile * c + tile * xs + nwc * sx_n * mr + sx_n * mr + mr
    # then a 4-byte flag and four 8-byte slab barriers
    smem = -(-(-(-(4 * floats + 4) // 8) * 8 + 32) // 16) * 16
    return cw, rw, nwr, mr, xs, 32 * nwc * nwr, smem


@functools.lru_cache(maxsize=4096)
def plan_k1(m: int, kp: int, np_: int, tile: int, sx_n: int, sw_n: int, adc_mode: str,
            bm: int, radc: int = 1024) -> K1Plan:
    """The launch geometry of a K1 / K4 call of ``m`` rows on (Kp, Np)
    weights of ``tile``-square crossbars.  Column slabs split a tile two
    ways where the cluster stays within 8 CTAs and the slab keeps 32
    columns (128-wide tiles always, 64-wide ones when the call has fewer
    than ``TARGET_CTAS`` CTAs without); up to 32 rows (or a whole
    ``dynamic`` tile, where it fits) make one row unit; row units spread
    over grid z until the call has ``TARGET_CTAS`` CTAs."""
    nk, nn = kp // tile, np_ // tile
    split = sw_n * 2 <= MAX_CLUSTER and tile >= 64
    sc = 2 if split and ((tile >= 128 and m > 4) or nk * nn * sw_n < TARGET_CTAS) else 1
    csize = sw_n * sc
    m = max(m, 1)
    dyn = radc > 1 and adc_mode == "dynamic"
    two_pass = 0
    if dyn:
        need = min(bm, m)
        g = _geometry(need, tile, sc, sx_n)
        if g[6] <= SMEM_MAX and g[5] <= MAX_THREADS:
            units, upt = -(-m // bm), 1  # one unit a range tile
        else:
            g = _geometry(min(need, UNIT_ROWS), tile, sc, sx_n)
            upt = -(-need // g[3])
            units, two_pass = -(-m // bm) * upt, 1
        bmr = bm
    else:
        g = _geometry(min(m, UNIT_ROWS), tile, sc, sx_n)
        units, upt, bmr = -(-m // g[3]), 1, g[3]
    cw, rw, nwr, mr, xs, threads, smem = g
    if two_pass:
        upc, z = 1, units
    else:
        z = min(units, max(1, -(-TARGET_CTAS // (nn * nk * csize))))
        upc = -(-units // z)
        z = -(-units // upc)
    # decode: the pairs go through device memory to the tile's last CTA
    # where they fit the slab's place (no cluster barriers on the path)
    gx = int(m <= 4 and units == 1 and not two_pass
             and sx_n * mr * sw_n <= tile // sc)
    if gx:  # the extra warps help with the inputs and the tile's epilogue
        threads = max(threads, GX_THREADS)
    return K1Plan(sc=sc, cw=cw, rw=rw, nwr=nwr, mr=mr, xs=xs, units=units, upt=upt, bmr=bmr,
                  upc=upc, z=z, two_pass=two_pass, smem=smem, threads=threads, gx=gx,
                  csize=csize, nn=nn, nk=nk, sx_n=sx_n, sw_n=sw_n, tile=tile)


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
        ctypes.c_void_p, ctypes.c_void_p,  # tickets, scratch
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # Kp, Np, tile
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # host int / float params, plan
    ] + ([ctypes.c_float] if name == "fused_sliced_matmul_launch" else []) + [  # drift
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


# Workspace of the calls on one (device, stream), which run one after
# another: K-block tickets (zero between calls: the kernel's last CTA of
# an output block resets its ticket) and float scratch for the K-block
# partials and the decode pairs (rewritten by every call).
_workspace: dict = {}


def _buffers(device, stream: int, n_tickets: int, n_floats: int):
    key = (device, stream)
    tickets, floats = _workspace.get(key, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 1 << 16), dtype=torch.int32, device=device)
    if floats is None or floats.numel() < n_floats:
        floats = torch.empty(max(n_floats, 1 << 20), dtype=torch.float32, device=device)
    _workspace[key] = (tickets, floats)
    return tickets.data_ptr(), floats.data_ptr()


def _launch(name, lead, m, ws, sw, kp, np_, tile, plan, params, device, tail=()):
    out = torch.empty((m, np_), dtype=torch.float32, device=device)
    if m == 0:
        return out
    n_part = (kp // tile) * m * np_ if kp > tile else 0
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        tickets, floats = _buffers(device, stream, plan.tickets, n_part + plan.scratch_floats)
        rc = _entry(name)(
            *lead, ws.data_ptr(), sw.data_ptr(), floats if n_part else None, out.data_ptr(),
            tickets, floats + 4 * n_part if plan.scratch_floats else None,
            kp, np_, tile, params[0], params[1], plan.ints_ptr, *tail, stream,
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
    drift: float = 1.0,
) -> torch.Tensor:
    """Launch K1 on the card: x (M, K) float32 raw activations, ws
    (Sw, Kp, Np) float32 programmed slices, sw (nk, nn) float32 block
    scales -> (M, Np) float32; ``bm`` rows share a ``dynamic`` range
    (any ``bm >= 1``: ``bm >= M`` is one range over the whole call); a
    float32 ``drift`` factor other than 1 multiplies each slice value as
    it is loaded (the plain version on ``ws * drift``).  Raises on
    anything the kernel does not take (it never falls back to the plain
    version)."""
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
    plan = plan_k1(m, kp, np_, tile, input_spec.n_slices, weight_spec.n_slices, adc_mode, bm,
                   radc)
    out = _launch("fused_sliced_matmul_launch", (x.data_ptr(), k, m, k), m, ws, sw,
                  kp, np_, tile, plan, params, x.device, (float(np.float32(drift)),))
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
    plan = plan_k1(m, kp, np_, tile, sxn, weight_spec.n_slices, adc_mode, bm, radc)
    out = _launch("staged_sliced_matmul_launch", (xs.data_ptr(), sx.data_ptr(), m), m,
                  ws, sw, kp, np_, tile, plan, params, xs.device)
    if m:
        staged_counter.count += 1
    return out
