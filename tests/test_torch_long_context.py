"""K2 / K3 at qwen2-0.5b's head layout and long contexts, on the CPU.

* The plain K3 against ``repro.kernels.paged_attention.
  paged_chunk_attention`` in interpret mode at qwen2-0.5b's heads (14
  query heads over 2 KV heads, head_dim 64, block size 16) in a 64-block
  table: chunks of 32 rows with 24 valid, starting at 0, on both sides of
  a block edge and at 1,000; window 0 and 24; float32 and bf16.
* The shared-memory layout of K2 / K3 (``group_layout``), which the
  wrappers check and the CUDA source repeats: a score region sized by
  the table a block walks, small for short tables and capped for long
  ones, every table up to 2,048 blocks (qwen2-0.5b's 32,768 positions at
  block size 16) accepted, and where a block keeps its scores or
  recomputes them.
* The port's ``ServeLoop`` does not depend on ``max_len``: the block
  table's width changes, the tokens and logits do not.
* The plain versions' chains round each step once, as the kernels do.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro_torch.configs import get_smoke
from repro_torch.core import INT8, DPEConfig, MemPolicy
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models import init_params
from repro_torch.serve import Request, ServeConfig, ServeLoop

torch.set_num_threads(1)

H, KV, HD, BS = 14, 2, 64, 16  # qwen2-0.5b's attention heads


def _rel_max(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("start", [0, 15, 16, 1000])
def test_paged_chunk_plain_matches_reference_served_heads(dtype, window, start):
    c, n_valid, nb = 32, 24, 64
    n_blocks = 1 + nb
    rng = np.random.default_rng(start + window)
    pk, pv = (rng.standard_normal((n_blocks, BS, KV, HD)).astype(np.float32) for _ in range(2))
    bt_row = (rng.permutation(n_blocks - 1) + 1).astype(np.int32)
    bt_row[(start + n_valid - 1) // BS + 1:] = 0  # unmapped tail -> trash block
    q = rng.standard_normal((1, c, H, HD)).astype(np.float32)
    jk, jv = (jnp.asarray(a).astype(dtype) for a in (pk, pv))
    jq = jnp.asarray(q).astype(dtype)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tk, tv, tq = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(tdt) for a in (jk, jv, jq))
    y_j = jpa.paged_chunk_attention(jq, jk, jv, jnp.asarray(bt_row), jnp.int32(start),
                                    jnp.int32(n_valid), window=window, interpret=True)
    y_t = tpa.paged_chunk_attention_ref(tq, tk, tv, torch.from_numpy(bt_row), start, n_valid,
                                        window=window)
    assert y_t.dtype == tdt and tuple(y_t.shape) == (1, c, H, HD)
    a = y_t.float().numpy()[0, :n_valid]  # pad query rows are discarded
    b = np.asarray(y_j.astype(jnp.float32))[0, :n_valid]
    if window or start + n_valid <= 64:
        assert _rel_max(a, b) <= 1e-6
    else:
        # up to 1,024 keys: the plain version's P.V sums run in key order
        # (the kernel's chains), XLA's dot pairwise, so they part by the
        # rounding of a 1,024-term float32 sum (1.3e-6 - 2.0e-6 on these
        # seeds); both stay within 2e-6 of the float64 result.  In bf16
        # that moves a few weights p / l and outputs across a bf16 rounding
        # boundary: within one bf16 step (2**-8) of the largest output
        if dtype == jnp.float32:
            assert _rel_max(a, b) <= 4e-6
            exact = _exact_chunk(q, pk, pv, bt_row, start, n_valid)
            assert _rel_max(a, exact) <= 2e-6 and _rel_max(b, exact) <= 2e-6
        else:
            assert _rel_max(a, b) <= 2.0**-8 and np.mean(a != b) < 0.05


def _exact_chunk(q, pk, pv, bt_row, start, n_valid):
    """float64 causal attention of the chunk's valid rows over the table."""
    k, v = (p[bt_row].reshape(-1, KV, HD).astype(np.float64) for p in (pk, pv))
    ki = np.arange(k.shape[0])
    out = np.zeros((n_valid, H, HD))
    for i in range(n_valid):
        for h in range(H):
            s = k[:, h // (H // KV)] @ q[0, i, h].astype(np.float64) * float(np.float32(HD**-0.5))
            s = np.where(ki <= start + i, s, -np.inf)
            p = np.exp(s - s.max())
            out[i, h] = (p / p.sum()) @ v[:, h // (H // KV)]
    return out


# --- the shared-memory layout (kernels/paged_attention.py::group_layout) ---

SMEM_MAX = 232_448
# (G, head_dim, block size, vector tiles): qwen2-0.5b, its smoke config
# (head_dim 18: float32 rows), one query head per KV head, head_dim 128
SHAPES = [(7, 64, 16, True), (7, 18, 8, False), (1, 64, 16, True), (7, 128, 16, True),
          (4, 80, 32, False)]


@pytest.mark.parametrize("kv_bytes", [4, 2])
@pytest.mark.parametrize("g,hd,bs,vec", SHAPES)
def test_layout_is_fixed_and_takes_any_table_up_to_2048_blocks(g, hd, bs, vec, kv_bytes):
    """q, normalisers and tiles are fixed per head shape; the region grows
    with the table a block walks until it takes all the tiles leave."""
    first = tpa.group_layout(g, hd, bs, vec, kv_bytes, 1)
    prev = 0
    for nb in range(1, 2049):
        lay = tpa.group_layout(g, hd, bs, vec, kv_bytes, nb)
        assert lay.ok and lay.total <= SMEM_MAX
        assert lay[:6] == first[:6] and lay.room == first.room  # the fixed part
        # q, normalisers and maxima, then the region, then the four tiles
        assert lay.region >= 4 * g * hd + 8 * g and lay.region % 16 == 0
        assert lay.region + lay.region_bytes + 4 * lay.tile_bytes == lay.total
        assert lay.region + lay.room + 4 * lay.tile_bytes <= SMEM_MAX
        # always one tile's scores and the entries; every score where it fits
        entries = -(-4 * nb // 16) * 16
        assert lay.tile_sc_bytes + entries <= lay.region_bytes <= lay.room
        assert lay.region_bytes % 16 == 0 and lay.region_bytes >= prev
        prev = lay.region_bytes
        if lay.region_bytes < lay.room:
            assert keeps_scores(lay, g, 0, nb * bs - 1, bs)
    if g > 1:  # 2,048 blocks of a group's scores take the whole room
        assert lay.region_bytes == lay.room
    assert lay.stage_keys % bs == 0 and lay.stage_keys >= min(bs, 64)
    # one tile's scores (from the tile's first key rounded down to 4)
    assert lay.tkp >= lay.stage_keys + 3 and lay.tkp % 32 == 4
    assert lay.tile_sc_bytes >= 4 * g * lay.tkp
    # no table width up to 2,048 blocks is refused, nor 32,768 positions
    assert tpa.max_table_blocks(lay) >= 2048
    assert tpa.max_table_blocks(lay) * bs >= 32_768
    need = _need()
    for nb in range(1, 2049):
        tpa._check_layout(need, g, hd, bs, nb, vec, kv_bytes)
    top = tpa.max_table_blocks(lay)
    assert tpa.group_layout(g, hd, bs, vec, kv_bytes, top).ok
    assert not tpa.group_layout(g, hd, bs, vec, kv_bytes, top + 4).ok
    with pytest.raises(ValueError, match="block table"):
        tpa._check_layout(need, g, hd, bs, top + 1, vec, kv_bytes)


def _need():
    def need(cond, msg):
        if not cond:
            raise ValueError(msg)

    return need


def keeps_scores(lay, g, lo, hi, bs):
    """What a K2 / K3 block decides on the device (``attend_group``):
    it keeps all its scores when its ``g`` score rows over keys
    ``lo..hi`` and its live table entries fit the region."""
    live = hi // bs - lo // bs + 1
    rows = -(-4 * g * tpa.score_stride((lo & 3) + hi - lo + 1) // 16) * 16
    return rows + 4 * live <= lay.region_bytes


def test_served_heads_keep_scores_up_to_the_old_cap():
    """At qwen2-0.5b's heads a decode block keeps every score up to pos
    5,667 in float32 (6,851 in bf16), past the 5,664 positions the old
    layout allowed at all; beyond, it recomputes them per pass.  A chunk
    row keeps them where its own live keys fit, whatever the table."""
    for kv_bytes, last in ((4, 5667), (2, 6851)):
        lay = tpa.group_layout(7, 64, 16, True, kv_bytes, 2048)
        assert keeps_scores(lay, 7, 0, last, 16)
        assert not keeps_scores(lay, 7, 0, last + 1, 16)
        for p in (0, 37, 255, 4095):
            assert keeps_scores(lay, 7, 0, p, 16)
        assert not keeps_scores(lay, 7, 0, 32_767, 16)
        assert keeps_scores(lay, 7, 32_767 - 23, 32_767, 16)  # a window of 24
    # the served row layout: 256 threads, one per dim in the P.V chains
    assert tpa.THREADS == 256


@pytest.mark.parametrize("kv_bytes", [4, 2])
def test_short_tables_keep_a_small_layout(kv_bytes):
    """The served shapes at qwen2-0.5b's heads: K2 in a 16-block table and
    K3 over blocks 0..4 (a 32-row chunk at start 37) ask for little
    enough shared memory that two blocks share an SM (228 KB an SM, 1 KB
    reserved a block), so a grid past 132 blocks does not run in extra
    waves; a 2,048-block table takes one block an SM."""
    for nb in (5, 16):
        lay = tpa.group_layout(7, 64, 16, True, kv_bytes, nb)
        assert 2 * (lay.total + 1024) <= 233_472
        assert keeps_scores(lay, 7, 0, nb * 16 - 1, 16)
    assert tpa.group_layout(7, 64, 16, True, kv_bytes, 2048).total > 233_472 // 2


def test_layout_refuses_what_does_not_fit():
    assert not tpa.group_layout(7, 256, 16, False, 4, 1).ok  # four float32 tiles of 256 dims
    need = _need()
    with pytest.raises(ValueError, match="head_dim 300"):
        tpa._check_layout(need, 1, 300, 16, 4, False, 4)
    with pytest.raises(ValueError, match="do not fit"):
        tpa._check_layout(need, 7, 256, 16, 4, False, 4)


# --- ServeLoop: the table width does not change the result ---

def test_serveloop_max_len_invariant():
    """qwen2-smoke through the faithful ServeLoop (``dynamic_row`` ADC,
    the kernels' plain versions on the CPU) at ``max_len`` 64 and 1,024:
    the block tables are 8 and 128 entries wide, the tokens are equal and
    every logit row is bit-equal."""
    cfg = get_smoke("qwen2-0.5b")
    params = init_params(cfg, 0, device="cpu")
    policy = MemPolicy(default=DPEConfig(
        input_spec=INT8, weight_spec=INT8, array_size=(32, 32), mode="faithful",
        adc_mode="dynamic_row", backend="auto"))
    rng = np.random.default_rng(15)
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32), g)
            for i, (n, g) in enumerate([(11, 4), (5, 3), (19, 3)])]
    sc = ServeConfig(policy=policy, slots=2, max_len=64, prefill_chunk=8, block_size=8,
                     compute_dtype=torch.float32, device="cpu", collect_logits=True)
    short = ServeLoop(params, cfg, sc)
    long = ServeLoop(params, cfg, sc.replace(max_len=1024), programmed=short.programmed)
    assert long.blocks_per_slot == 16 * short.blocks_per_slot
    a, b = short.run(reqs), long.run(reqs)
    for ra, rb in zip(a.results, b.results):
        assert ra.tokens == rb.tokens and len(ra.logits) == len(rb.logits) > 0
        assert all(np.array_equal(x, y) for x, y in zip(ra.logits, rb.logits))


def test_plain_chains_round_once():
    """The plain versions' chains round each fused multiply-add once, as
    the kernels' ``fmaf`` does: the second step of these chains lands the
    float64 sum 1 + 2**-11 + 2**-24 (+ 2**-80 lost) halfway between two
    float32 values, which float64-then-float32 rounding would round to
    even.  At a 32K context such a step comes about once a call."""
    want = np.float32(1 + 2**-11 + 2**-23)
    x = torch.tensor([[2.0**-40, 1 + 2**-12]])
    assert tpa._dots(x, x).item() == want
    assert tpa._weighted_sum(x, x.T).item() == want
