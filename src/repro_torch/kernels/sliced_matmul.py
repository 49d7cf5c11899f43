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

K1 on an expert stack (``fused_sliced_matmul_cuda`` given x (E, M, K))
replaces the reference's ``vmap`` of the fused kernel over an MoE layer's
experts (``repro/models/moe.py`` :112-122, one Pallas kernel with an
extra grid axis): one launch for every expert of a projection, each
expert bit-equal to K1 on it alone; its plain version computes the live
experts at once.  One weight is a stack of one.

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

A call's K-block partials take 4 B x E x nk x M x Np of device memory
(nk times its output), kept for the next call.  A call whose partials
would take more than half of the memory a new buffer can take runs as
consecutive row groups (:func:`row_groups`), each one launch on its rows
with a workspace of the call's own, which goes back to the card when the
call ends (one cache flush a grouped call; the kept one stays as it is):
a group holds whole ``bm``-row ``dynamic`` tiles (``dynamic_row`` and
``fullscale`` split anywhere), so every ADC range and every row's
in-order K-block sum are the ones of the whole call and the bits do not
change.  A ``dynamic`` call with ``bm >= M`` is one range and is never
split: past the free memory it raises.
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
    "row_groups",
    "fused_sliced_matmul_ref",
    "fused_sliced_matmul_cuda",
    "staged_sliced_matmul_cuda",
    "counter",
    "stack_counter",
    "staged_counter",
]

_EPS = 1e-30
TILES = (32, 64, 128)  # square crossbar tiles bk = bn the kernels take
INPUT_SLICES = (3, 4, 5, 6, 8)  # input slice counts the kernels are built for
MAX_SLICES = 8
counter = LaunchCounter("fused_sliced_matmul")
stack_counter = LaunchCounter("fused_sliced_matmul_stack")
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
    x: torch.Tensor,  # (..., M, K) raw float input, K <= Kp
    ws: torch.Tensor,  # (..., Sw, Kp, Np)
    sw: torch.Tensor,  # (..., nk, nn)
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
    slices times the float32 ``drift`` factor.  Only ``dynamic`` ranging
    depends on the row tiling: its rows share a range in tiles of ``bm``.
    The reference wrapper pads M with zero rows to whole tiles; here a
    partial last tile is ranged over its real rows alone, which gives the
    same bits (a zero row's partial sums are exact zeros, and a range
    clamped from below at 1e-30 cannot rise by a zero) at a fraction of
    the cost for a call of a few rows.  Leading dims of all three
    operands are calls of their own: an expert stack (E, M, K) is the
    reference's ``vmap`` of the fused kernel, every expert's ``dynamic``
    range tiles its own.  An expert whose rows are all zero (no token
    routed to it) gives exact zeros (+0.0, as the kernel does: zero
    slices, zero pair sums, zero codes) and is not computed.  Returns
    (..., M, Np) float32."""
    if x.dim() == 3 and ws.dim() == 4:  # an expert stack: compute its live experts
        live = torch.nonzero(x.reshape(x.shape[0], -1).ne(0).any(dim=1))[:, 0]
        if live.numel() < x.shape[0]:
            out = torch.zeros((x.shape[0], x.shape[1], ws.shape[-1]), dtype=torch.float32,
                              device=x.device)
            if live.numel():
                out[live] = fused_sliced_matmul_ref(
                    x[live], ws[live], sw[live], input_spec=input_spec,
                    weight_spec=weight_spec, array_size=array_size, rdac=rdac, radc=radc,
                    adc_mode=adc_mode, bm=bm, drift=drift)
            return out
    bk, _ = array_size
    lead = x.shape[:-2]
    m, k = x.shape[-2:]
    kp = ws.shape[-2]
    if k > kp or kp - k >= bk:
        raise ValueError(f"K={k} inconsistent with prepared Kp={kp}")
    if m == 0:
        return x.new_zeros((*lead, 0, ws.shape[-1]), dtype=torch.float32)
    x = torch.nn.functional.pad(x.to(torch.float32), (0, kp - k))
    xs, sx = _prep_input(x.reshape(-1, kp), input_spec, bk, rdac)
    xs = xs.reshape(xs.shape[0], *lead, m, kp).movedim(0, -3)  # (..., Sx, M, Kp)
    sx = sx.reshape(*lead, m, -1)
    if drift != 1.0:
        ws = ws * torch.tensor(np.float32(drift), device=ws.device)
    kw = dict(input_spec=input_spec, weight_spec=weight_spec, array_size=array_size,
              radc=radc, adc_mode=adc_mode)
    tiled = adc_mode == "dynamic" and radc > 1
    full = m - m % bm if tiled else m
    parts = [sliced_matmul_ref(xs[..., :full, :], sx[..., :full, :], ws, sw,
                               bm=bm if tiled else m, **kw)] if full else []
    if full < m:
        parts.append(sliced_matmul_ref(xs[..., full:, :], sx[..., full:, :], ws, sw,
                                       bm=m - full, **kw))
    return torch.cat(parts, dim=-2) if len(parts) > 1 else parts[0]


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
    p, i = ctypes.c_void_p, ctypes.c_int
    fused = name == "fused_sliced_matmul_launch"
    fn.argtypes = (
        ([p, i, i, i, i] if fused else [p, p, i])  # x, ldx, M, K, E | xs, sx, M
        + [p, p, p, p, p]  # ws, sw, part, out, tickets
        + ([i] if fused else [])  # tickets an expert
        + [p]  # scratch
        + ([ctypes.c_longlong] if fused else [])  # scratch floats an expert
        + [i, i, i, p, p, p]  # Kp, Np, tile, host int / float params, plan
        + ([ctypes.c_float] if fused else [])  # drift
        + [p]  # stream
    )
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
# partials and the decode pairs (rewritten by every call).  It grows to
# the largest call not split in row groups and is kept: the K-block
# partials of a call are
# 4 B x E x nk x M x Np (E experts of a stack, nk K-blocks), which is
# nk times the call's output.
_workspace: dict = {}


def _free_bytes(device) -> int:
    """Device memory one new buffer can take: what the card has free and
    the caching allocator's wholly unused segments, which it gives back to
    the card when an allocation needs them.  The free space inside
    part-used segments is left out: it cannot take one large buffer."""
    s = torch.cuda.memory_stats(device)
    unused = (s.get("reserved_bytes.all.current", 0) - s.get("allocated_bytes.all.current", 0)
              - s.get("inactive_split_bytes.all.current", 0))
    return torch.cuda.mem_get_info(device)[0] + max(unused, 0)


def _buffers(device, stream: int, n_tickets: int, n_floats: int, shape=(), keep=True):
    """The workspace's (tickets, floats) tensors, grown to the call's
    ``n_tickets`` and ``n_floats``; with ``keep=False`` floats the kept
    buffer cannot take are the call's own (a row group's), and the kept
    buffer stays as it is.  Raises before it allocates past the memory a
    new buffer can take (``shape``: the call's (E, nk, M, Np) for the
    message)."""
    key = (device, stream)
    tickets, held = _workspace.pop(key, (None, None))
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 1 << 16), dtype=torch.int32, device=device)
    floats = held if held is not None and held.numel() >= n_floats else None
    if floats is None:
        if keep:
            held = None  # the old buffer is freed before the new one is taken
            n_floats = max(n_floats, 1 << 20)
        free = _free_bytes(device)
        if 4 * n_floats > free:
            _workspace[key] = (tickets, held)
            raise RuntimeError(
                f"K1 needs {4 * n_floats / 2**30:.2f} GiB of workspace (K-block partials of "
                f"4 B x E x nk x M x Np = {' x '.join(map(str, shape))}, and scratch) and the "
                f"card has {free / 2**30:.2f} GiB free: call it on fewer rows")
        floats = torch.empty(n_floats, dtype=torch.float32, device=device)
        if keep:
            held = floats
    _workspace[key] = (tickets, held)
    return tickets, floats


GROUP_SHARE = 0.5  # of the memory a new buffer can take that a call's workspace may


def row_groups(m: int, unit: int, row_bytes: int, budget: int) -> list[tuple[int, int]] | None:
    """Consecutive ``(start, stop)`` row ranges covering a call of ``m``
    rows that needs ``row_bytes`` of workspace a row: the whole call when
    it fits ``budget``, else ranges of as many whole ``unit``-row units as
    fit (the last range takes the rest).  ``None`` when not even one unit
    fits: the call cannot be split within the budget."""
    if m * row_bytes <= budget:
        return [(0, m)]
    rows = budget // max(row_bytes, 1) // unit * unit
    if rows == 0:
        return None
    return [(r, min(r + rows, m)) for r in range(0, m, rows)]


def _groups(device, e, m, k, nk, np_, unit):
    """The row groups of a K1 call on ``device``'s current stream: the
    whole call where the kept workspace takes its partials, or where they
    take at most ``GROUP_SHARE`` of the memory a new buffer can take
    (:func:`_free_bytes`); else groups whose partials, input copy and
    output do; whole where not one group fits (:func:`_buffers` then
    raises past the free memory)."""
    part = 4 * e * nk * np_ if nk > 1 else 0
    stream = torch.cuda.current_stream(device).cuda_stream
    held = _workspace.get((device, stream), (None, None))[1]
    if m <= 1 or not part or (held is not None and m * part <= 4 * held.numel()):
        return [(0, m)]
    budget = int(_free_bytes(device) * GROUP_SHARE)
    return row_groups(m, unit, part + 4 * e * (k + np_), budget) or [(0, m)]


def _launch(name, lead, m, ws, sw, kp, np_, tile, plan, params, device, tail=(), experts=1,
            keep=True):
    """One launch of ``name`` over ``experts`` weights (K1's stack; K4
    takes one), each with its own workspace (``keep``: see
    :func:`_buffers`).  Returns (experts, M, Np)."""
    out = torch.empty((experts, m, np_), dtype=torch.float32, device=device)
    if m == 0:
        return out
    nk = kp // tile
    n_part = experts * nk * m * np_ if nk > 1 else 0
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        t_buf, f_buf = _buffers(device, stream, experts * plan.tickets,
                                n_part + experts * plan.scratch_floats,
                                (experts, nk, m, np_), keep)
        tickets, floats = t_buf.data_ptr(), f_buf.data_ptr()
        scratch = floats + 4 * n_part if plan.scratch_floats else None
        mid = ((tickets, plan.tickets, scratch, plan.scratch_floats)
               if name == "fused_sliced_matmul_launch" else (tickets, scratch))
        rc = _entry(name)(
            *lead, ws.data_ptr(), sw.data_ptr(), floats if n_part else None, out.data_ptr(),
            *mid, kp, np_, tile, params[0], params[1], plan.ints_ptr, *tail, stream,
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
    it is loaded (the plain version on ``ws * drift``).  An expert stack,
    x (E, M, K), ws (E, Sw, Kp, Np), sw (E, nk, nn) -> (E, M, Np), is one
    launch, expert ``i`` bit-equal to the call on ``x[i], ws[i], sw[i]``
    (its ``dynamic`` range tiles its own, as in the reference's ``vmap``
    of the fused kernel), counted by ``stack_counter``.  A call whose
    K-block partials would take more than half of the free memory is one
    launch a row group (:func:`row_groups`), with the same bits; each
    launch counts, and the groups' workspace goes back to the card.
    Raises on anything the kernel does not take (it never falls back to
    the plain version)."""
    who = "fused_sliced_matmul_cuda"
    stack = x.dim() == 3
    _need(who, x.dim() in (2, 3) and ws.dim() == x.dim() + 1 and sw.dim() == x.dim(),
          "bad ranks: x (M, K), ws (Sw, Kp, Np), sw (nk, nn), or a stack of each")
    xe, wse, swe = (x, ws, sw) if stack else (x[None], ws[None], sw[None])
    e, m, k = xe.shape
    _need(who, e >= 1 and wse.shape[0] == e and swe.shape[0] == e, "expert counts differ")
    tile, nk, kp, np_ = _check_weights(
        who, wse[0], swe[0], input_spec, weight_spec, array_size, adc_mode,
        (("x", x), ("ws", ws), ("sw", sw)),
    )
    _need(who, bm >= 1, f"bm={bm} must be positive")
    _need(who, k <= kp and kp - k < tile, f"K={k} inconsistent with Kp={kp}")
    _need(who, e * nk <= 65535, f"{e} experts x {nk} K-blocks exceed grid y")
    params = _spec_arrays(input_spec, weight_spec, rdac, radc, adc_mode, tile)
    unit = min(bm, m) if adc_mode == "dynamic" and radc > 1 else 1
    groups = _groups(x.device, e, m, k, nk, np_, unit)
    whole = len(groups) == 1
    out = None if whole else torch.empty((e, m, np_), dtype=torch.float32, device=x.device)
    for r0, r1 in groups:
        rows = r1 - r0
        xg = xe[:, r0:r1].contiguous()
        plan = plan_k1(rows, kp, np_, tile, input_spec.n_slices, weight_spec.n_slices,
                       adc_mode, bm, radc)
        part = _launch("fused_sliced_matmul_launch", (xg.data_ptr(), k, rows, k, e), rows,
                       ws, sw, kp, np_, tile, plan, params, x.device,
                       (float(np.float32(drift)),), experts=e, keep=whole)
        if rows:
            (stack_counter if stack else counter).count += 1
        if out is None:
            out = part
        else:
            out[:, r0:r1] = part
        del xg, part
    if not whole:
        # the groups' workspace goes back to the card whole: left in the cache,
        # later allocations split it and the next grouped call cannot take it
        with torch.cuda.device(x.device):
            torch.cuda.empty_cache()
    return out if stack else out[0]


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
    return out[0]
