"""The launch geometry of K1 / K4 (``kernels/sliced_matmul.py::plan_k1``).

The geometry is computed in Python and passed to the CUDA entry, which
only checks it, so what the kernel needs of it is held here on the CPU:
shared memory within an H100 block's 232,448 bytes and threads within
512 for every tile, preset and row class; clusters of at most 8 CTAs;
every (n-block, K-block, row) computed by exactly one CTA per weight
slice and column slab, and every output recombined and K-summed exactly
once; a one-pass ``dynamic`` unit holding a whole range tile; and at
qwen2-0.5b's decode shapes enough CTAs to fill the card.
"""
import numpy as np
import pytest

from repro_torch.core import presets
from repro_torch.kernels import sliced_matmul as sm

SMEM_MAX = 232_448
PRESET_PAIRS = [("int8", "int8"), ("int8", "int4"), ("fp32", "fp32"), ("flex16_5", "flex16_5"),
                ("bf16", "bf16"), ("fp16", "fp16"), ("int4", "int4")]
ROWS = [1, 2, 3, 4, 5, 8, 31, 32, 33, 64, 128, 130, 150]
MODES = [("dynamic_row", 128), ("fullscale", 128), ("dynamic", 16), ("dynamic", 64),
         ("dynamic", 128), ("dynamic", 1 << 20)]

# qwen2-0.5b's projections (K, N), padded to 128x128 tiles
SERVED = {"q/o": (896, 896), "k/v": (896, 128), "wi/wg": (896, 4864), "wo": (4864, 896),
          "lm_head": (896, 151936)}


def _pad(n, t):
    return -(-n // t) * t


def _geometry_ok(p: sm.K1Plan, tile: int, m: int, sx_n: int, sw_n: int, adc_mode: str, bm: int):
    """What ``plan_ok`` in ``csrc/sliced_matmul.cuh`` refuses."""
    c = tile // p.sc
    nwc = c // (32 * p.cw)
    assert p.csize == sw_n * p.sc <= 8
    assert tile % p.sc == 0 and c % 32 == 0 and p.cw == (1 if c == 32 else 2)
    assert p.rw in (2, 4)
    chain_threads = 32 * nwc * p.nwr
    assert p.mr == p.rw * p.nwr and p.threads <= 512
    assert p.threads == (max(chain_threads, 128) if p.gx else chain_threads)
    assert p.xs >= p.mr * sx_n and p.xs % 4 == 0 and p.xs % 32 != 0
    assert p.smem <= SMEM_MAX
    floats = tile * c + tile * p.xs + nwc * sx_n * p.mr + sx_n * p.mr + p.mr
    assert p.smem >= 4 * floats + 4 + 32  # a flag, four slab barriers
    # the quantised pairs (Sx, MR, C) fit where the prepared inputs were
    assert sx_n * p.mr * c <= tile * p.xs
    assert p.upc * p.z >= p.units and (p.z - 1) * p.upc < p.units
    dyn = adc_mode == "dynamic"
    if dyn and not p.two_pass:
        assert p.upt == 1 and min(bm, m) <= p.mr
    if not dyn:
        assert not p.two_pass and p.upt == 1 and p.bmr == p.mr
    if p.gx:  # decode exchange: one unit, the tile's pairs in the slab's place
        assert m <= 4 and p.units == 1 and not p.two_pass and sx_n * p.mr * sw_n <= c
        assert p.scratch_floats == p.nk * p.nn * sx_n * p.mr * sw_n * tile
        assert p.tickets == p.nn * (p.nk + 1)
    # the two ranges a `gx` tile keeps fit where the prepared inputs were
    assert 2 * sx_n * p.mr * sw_n <= tile * p.xs


def _unit_rows(p: sm.K1Plan, m: int, u: int):
    """Rows ``[lo, lo + n)`` of row unit ``u`` and its range tile (the
    kernel's ``unit_rows``)."""
    t, s = divmod(u, p.upt)
    lo = t * p.bmr + s * p.mr
    hi = min(lo + p.mr, (t + 1) * p.bmr, m)
    return lo, max(0, hi - lo), t


def _coverage(p: sm.K1Plan, m: int, sw_n: int, tile: int):
    """Per (slab, jw): how often each row's chains are computed; per
    output (row, column) of a tile: how often it is recombined and how
    often K-summed (the kernel's index arithmetic, one (n-block, K-block);
    the grid repeats it over (nn, nk))."""
    c = tile // p.sc
    chains = np.zeros((p.sc, sw_n, m), np.int64)
    recomb = np.zeros((m, tile), np.int64)
    for z in range(p.z):
        u0, u1 = z * p.upc, min(z * p.upc + p.upc, p.units)
        if _unit_rows(p, m, u0)[1] == 0:
            continue  # the kernel returns: an empty tail unit
        for u in range(u0, u1):
            lo, n, tile_ix = _unit_rows(p, m, u)
            if n == 0:
                break
            assert lo >= tile_ix * p.bmr and lo + n <= (tile_ix + 1) * p.bmr  # within a range tile
            for rank in range(p.csize):
                slab, jw = divmod(rank, sw_n)
                chains[slab, jw, lo:lo + n] += 1
                if p.gx:
                    continue
                # CTA jw of a slab recombines (and K-sums) a contiguous
                # share of the unit's n x C outputs
                each = -(-(n * c) // sw_n)
                for e in range(min(n * c, jw * each), min(n * c, (jw + 1) * each)):
                    r, col = divmod(e, c)
                    recomb[lo + r, slab * c + col] += 1
            if p.gx:  # the tile's last CTA recombines (and K-sums) it all
                recomb[lo:lo + n, :] += 1
    return chains, recomb


@pytest.mark.parametrize("pair", PRESET_PAIRS, ids=lambda s: "x".join(s))
@pytest.mark.parametrize("tile", sm.TILES)
def test_plan_fits_and_covers_every_row_once(pair, tile):
    sxs, sws = (presets.spec(n) for n in pair)
    sx_n, sw_n = sxs.n_slices, sws.n_slices
    for m in ROWS:
        for adc_mode, bm in MODES:
            for kp, np_ in ((tile, tile), (3 * tile, 2 * tile), (7 * tile, 38 * tile)):
                p = sm.plan_k1(m, kp, np_, tile, sx_n, sw_n, adc_mode, bm)
                _geometry_ok(p, tile, m, sx_n, sw_n, adc_mode, bm)
                assert (p.nn, p.nk) == (np_ // tile, kp // tile)
                chains, recomb = _coverage(p, m, sw_n, tile)
                assert (chains == 1).all(), (m, adc_mode, bm, kp, np_)
                assert (recomb == 1).all(), (m, adc_mode, bm, kp, np_)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 32])
@pytest.mark.parametrize("name", list(SERVED))
def test_served_plan_fills_the_card(name, m):
    """At qwen2-0.5b's shapes (int8 x int8, 128x128, ``dynamic_row``): one
    launch, and at decode at least two CTAs per SM for every projection
    of 33 tiles or more (k/v has 7 tiles: 8 CTAs each)."""
    k, n = SERVED[name]
    kp, np_ = _pad(k, 128), _pad(n, 128)
    p = sm.plan_k1(m, kp, np_, 128, 4, 4, "dynamic_row", 128)
    tiles = (kp // 128) * (np_ // 128)
    assert p.launches == 1 and p.units == 1 and p.z == 1
    assert p.gx == (m <= 4)  # decode exchanges its pairs through device memory
    # a tile's four weight slices take a CTA each; two column slabs each
    # where the call would have fewer than two CTAs per SM without, and
    # in every prefill chunk (two CTAs of a slab fit an SM)
    split = m > 4 or 4 * tiles < 264
    assert p.csize == (8 if split else 4)
    assert p.ctas == p.csize * tiles
    if m <= 4:
        assert p.rw == 2 and p.threads == 128  # one chain warp or two, the rest help
        assert p.ctas >= (264 if tiles >= 33 else 7 * 4)
    else:
        assert p.mr == 32  # the whole chunk in one unit: every weight read once
    # several CTAs in flight per SM
    assert p.smem <= SMEM_MAX // (3 if m <= 4 else 2)


def test_table2_is_one_pass():
    """K4 at the paper's Table 2 shape (M 128, 64x64 tiles, ``dynamic``
    over bm = 64 rows): each bm tile is one unit, one launch."""
    p = sm.plan_k1(128, 1024, 1024, 64, 4, 4, "dynamic", 64)
    assert not p.two_pass and p.launches == 1 and p.units == 2 and p.mr == 64
    assert p.ctas >= 264


@pytest.mark.parametrize("m,bm", [(150, 150), (130, 128), (150, 64), (128, 128)])
def test_dynamic_range_tiles(m, bm):
    """``dynamic`` with 64x64 int8 and fp32 tiles: a tile that does not
    fit one unit is a range pass and a quantise pass over units of one
    tile; one that fits is one unit."""
    for sx_n, sw_n in ((4, 4), (8, 8)):
        p = sm.plan_k1(m, 5 * 64, 2 * 64, 64, sx_n, sw_n, "dynamic", bm)
        fits = min(bm, m) <= p.mr
        assert bool(p.two_pass) != fits
        assert p.launches == (2 if p.two_pass else 1)
        if p.two_pass:
            assert p.upt == -(-min(bm, m) // p.mr) and p.upc == 1 and p.z == p.units
        # a tile padded past M is the reference's zero rows: the kernel
        # adds 0 to its range exactly when (t + 1) * bm > M
        padded = [(t + 1) * p.bmr > m for t in range(-(-m // bm))]
        assert padded[-1] == (m % bm != 0 or bm > m)


def test_no_range_without_adc():
    """radc 1 quantises nothing: ``dynamic`` needs no range tiles."""
    p = sm.plan_k1(150, 5 * 64, 2 * 64, 64, 4, 4, "dynamic", 150, radc=1)
    assert not p.two_pass and p.bmr == p.mr


# (M, unit, row bytes, budget): qwen3-moe's wi at batch 4 and a 3,072-token
# prompt (960 buffer rows, 25.17 MB of partials a row) beside ~9 GiB, and
# small cases at the edges
GROUP_CASES = [(960, 128, 25_165_824, 9 * 2**30), (960, 1, 25_165_824, 9 * 2**30),
               (130, 128, 10, 1_000), (300, 128, 10, 2_560), (300, 128, 10, 2_559),
               (7, 1, 3, 10), (256, 256, 10, 2_559), (256, 256, 10, 2_560)]


@pytest.mark.parametrize("m,unit,row_bytes,budget", GROUP_CASES)
def test_row_groups_are_whole_tiles_in_order(m, unit, row_bytes, budget):
    """K1's row groups (``row_groups``): the whole call where it fits;
    else consecutive ranges that cover M in order, each but the last a
    whole number of ``unit`` rows (a ``dynamic`` range tile), each within
    the budget; ``None`` where not one unit fits (a ``dynamic`` call with
    ``bm >= M`` is one unit of M rows and is never split)."""
    groups = sm.row_groups(m, unit, row_bytes, budget)
    if m * row_bytes <= budget:
        assert groups == [(0, m)]
        return
    if unit * row_bytes > budget:
        assert groups is None
        return
    assert groups[0][0] == 0 and groups[-1][1] == m and len(groups) > 1
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    for r0, r1 in groups:
        assert r0 % unit == 0 and 0 < r1 - r0
        assert (r1 - r0) * row_bytes <= budget
    assert all((r1 - r0) % unit == 0 for r0, r1 in groups[:-1])
    # the largest group that fits: one more unit would not
    assert (groups[0][1] + unit) * row_bytes > budget
