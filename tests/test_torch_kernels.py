"""The port's kernel modules against the JAX reference kernels.

Each kernel of the serving path has a plain PyTorch version beside it;
on the CPU the dispatch point (``repro_torch.kernels.ops``) runs that
plain version.  Here it is held against the reference's Pallas kernel
run in interpret mode, on the same numpy inputs:

* K1, the fused faithful sliced matmul: the port's
  ``fused_sliced_matmul_ref`` vs ``fused_sliced_matmul_pallas`` and the
  reference's ``sliced_matmul_ref``, all three ADC modes, on the
  reference's own noisy programmed slices; rel-Fro <= 1e-5 (the slice-pair
  dots are summed in another order, which can move an ADC code).
* K2 / K3, paged decode and chunk attention: the port's plain versions
  vs ``paged_decode_attention`` / ``paged_chunk_attention``, random block
  tables that include the trash block, window 0 and 4; pad query rows
  excluded; max rel <= 1e-6.

The CUDA wrappers themselves run only on the card
(``tests/test_torch_cuda.py``); here they must refuse CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DPEConfig as JDPEConfig
from repro.core import dpe as jdpe
from repro.core import spec as jspec
from repro.kernels import paged_attention as jpa
from repro.kernels.ref import sliced_matmul_ref as j_sliced_matmul_ref
from repro.kernels.sliced_matmul import fused_sliced_matmul_pallas
from repro_torch.core import spec
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import sliced_matmul as tsm
from repro_torch.kernels.ref import sliced_matmul_ref

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

ARRAY = (32, 32)
BM = 8


def _rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def programmed():
    """The reference's noisy programmed slices of one (70, 50) weight."""
    cfg = JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"), array_size=ARRAY)
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((70, 50)) * 0.1).astype(np.float32)
    pw = jdpe.prepare_weight(jnp.asarray(w), cfg, jax.random.PRNGKey(3))
    return np.asarray(pw.slices), np.asarray(pw.scale)


@pytest.mark.parametrize("adc_mode", ["dynamic", "dynamic_row", "fullscale"])
@pytest.mark.parametrize("m", [1, 5])
def test_fused_sliced_matmul_plain_matches_reference(programmed, adc_mode, m):
    slices, scale = programmed
    kw = dict(input_spec=jspec("int8"), weight_spec=jspec("int8"), array_size=ARRAY,
              rdac=256, radc=1024, adc_mode=adc_mode)
    x = np.random.default_rng(m).standard_normal((m, 70)).astype(np.float32)
    kp = slices.shape[1]
    xp = np.zeros((BM, kp), np.float32)
    xp[:m, :70] = x
    y_kernel = np.asarray(fused_sliced_matmul_pallas(
        jnp.asarray(xp), jnp.asarray(slices), jnp.asarray(scale), bm=BM, interpret=True, **kw))[:m]
    jc = JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"), array_size=ARRAY)
    xs, sx = jdpe.prepare_input(jnp.asarray(xp), jc)
    y_ref = np.asarray(j_sliced_matmul_ref(
        xs, sx, jnp.asarray(slices), jnp.asarray(scale), bm=BM,
        **{k: v for k, v in kw.items() if k != "rdac"}))[:m]

    tkw = dict(kw, input_spec=spec("int8"), weight_spec=spec("int8"))
    y = tsm.fused_sliced_matmul_ref(
        torch.from_numpy(x), torch.from_numpy(slices), torch.from_numpy(scale), bm=BM, **tkw
    ).numpy()
    assert y.shape == (m, slices.shape[2])
    assert _rel_fro(y, y_kernel) <= 1e-5
    assert _rel_fro(y, y_ref) <= 1e-5
    # the dispatch point takes the plain version for a CPU tensor
    before = tsm.counter.count
    y_ops = ops.fused_sliced_matmul(
        torch.from_numpy(x), torch.from_numpy(slices), torch.from_numpy(scale), **tkw)
    assert tsm.counter.count == before
    if adc_mode != "dynamic":  # only dynamic ranging depends on the row tiling
        assert np.array_equal(y_ops.numpy(), y)


def test_port_sliced_matmul_ref_matches_reference(programmed):
    """The staged oracle on the same DAC'd slices, noisy weights."""
    slices, scale = programmed
    jc = JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"), array_size=ARRAY)
    x = np.random.default_rng(9).standard_normal((BM, 70)).astype(np.float32)
    xs, sx = jdpe.prepare_input(jnp.asarray(x), jc)
    for adc_mode in ("dynamic", "dynamic_row", "fullscale"):
        kw = dict(array_size=ARRAY, radc=1024, adc_mode=adc_mode, bm=BM)
        y_j = np.asarray(j_sliced_matmul_ref(
            xs, sx, jnp.asarray(slices), jnp.asarray(scale),
            input_spec=jspec("int8"), weight_spec=jspec("int8"), **kw))
        y_t = sliced_matmul_ref(
            torch.from_numpy(np.asarray(xs)), torch.from_numpy(np.asarray(sx)),
            torch.from_numpy(slices), torch.from_numpy(scale),
            input_spec=spec("int8"), weight_spec=spec("int8"), **kw).numpy()
        assert _rel_fro(y_t, y_j) <= 1e-5, adc_mode


def test_cuda_wrappers_refuse_cpu_tensors(programmed):
    slices, scale = programmed
    x = torch.zeros((2, 70))
    with pytest.raises(ValueError, match="CUDA"):
        tsm.fused_sliced_matmul_cuda(
            x, torch.from_numpy(slices), torch.from_numpy(scale), input_spec=spec("int8"),
            weight_spec=spec("int8"), array_size=(128, 128), rdac=256, radc=1024,
            adc_mode="dynamic_row")
    pool = torch.zeros((3, 8, 1, 18))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_attention_cuda(
            torch.zeros((1, 7, 18)), pool, pool, torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_chunk_attention_cuda(
            torch.zeros((1, 4, 7, 18)), pool, pool, torch.zeros((2,), dtype=torch.int32), 0, 4)


# ---------------------------------------------------------------------------
# K2 / K3: paged attention (qwen2-smoke heads: H=7, KV=1, hd=18)
# ---------------------------------------------------------------------------

H, KV, HD, BS, NB = 7, 1, 18, 8, 4


def _pools(seed, n_blocks, dtype):
    rng = np.random.default_rng(seed)
    pk = rng.standard_normal((n_blocks, BS, KV, HD)).astype(np.float32)
    pv = rng.standard_normal((n_blocks, BS, KV, HD)).astype(np.float32)
    return pk, pv


def _as(a, dtype):
    """numpy f32 -> (jax array, torch tensor) of the same values in dtype."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("window", [0, 4])
def test_paged_decode_plain_matches_reference_kernel(dtype, window):
    b = 3
    n_blocks = 1 + b * NB
    pk, pv = _pools(1, n_blocks, dtype)
    rng = np.random.default_rng(2)
    bt = (rng.permutation(n_blocks - 1)[: b * NB] + 1).reshape(b, NB).astype(np.int32)
    pos = np.array([0, 13, NB * BS - 1], np.int32)
    for i in range(b):  # unmapped tail entries point at the trash block
        bt[i, pos[i] // BS + 1:] = 0
    q = rng.standard_normal((b, H, HD)).astype(np.float32)
    jk, tk = _as(pk, dtype)
    jv, tv = _as(pv, dtype)
    y_j = jpa.paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(pos), window=window, interpret=True)
    y_t = tpa.paged_decode_attention_ref(
        torch.from_numpy(q), tk, tv, torch.from_numpy(bt), torch.from_numpy(pos), window=window)
    assert y_t.dtype == tk.dtype and tuple(y_t.shape) == (b, H, HD)
    assert _rel_max(y_t.float().numpy(), np.asarray(y_j.astype(jnp.float32))) <= 1e-6


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("window", [0, 24])
def test_paged_decode_plain_matches_reference_kernel_served_heads(dtype, window):
    """The same comparison at qwen2-0.5b's head layout (14 query heads
    over 2 KV heads, head_dim 64, block size 16), the width K2 serves on
    the card: pos 0, both sides of a block edge, the last position."""
    h, kv, hd, bs, nb = 14, 2, 64, 16, 3
    pos = np.array([0, bs - 1, bs, nb * bs - 1], np.int32)
    b = len(pos)
    n_blocks = 1 + b * nb
    rng = np.random.default_rng(14 + window)
    pk, pv = (rng.standard_normal((n_blocks, bs, kv, hd)).astype(np.float32) for _ in range(2))
    bt = (rng.permutation(n_blocks - 1)[: b * nb] + 1).reshape(b, nb).astype(np.int32)
    for i in range(b):  # unmapped tail entries point at the trash block
        bt[i, pos[i] // bs + 1:] = 0
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    jk, tk = _as(pk, dtype)
    jv, tv = _as(pv, dtype)
    y_j = jpa.paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(pos), window=window, interpret=True)
    y_t = tpa.paged_decode_attention_ref(
        torch.from_numpy(q), tk, tv, torch.from_numpy(bt), torch.from_numpy(pos), window=window)
    assert y_t.dtype == tk.dtype and tuple(y_t.shape) == (b, h, hd)
    assert _rel_max(y_t.float().numpy(), np.asarray(y_j.astype(jnp.float32))) <= 1e-6


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("start,n_valid,window", [(0, 8, 0), (5, 6, 0), (13, 8, 4), (21, 3, 4)])
def test_paged_chunk_plain_matches_reference_kernel(dtype, start, n_valid, window):
    c = 8
    n_blocks = 1 + 2 * NB
    pk, pv = _pools(3, n_blocks, dtype)
    rng = np.random.default_rng(4 + start)
    bt_row = (rng.permutation(n_blocks - 1)[:NB] + 1).astype(np.int32)
    bt_row[(start + n_valid - 1) // BS + 1:] = 0  # unmapped tail -> trash block
    q = rng.standard_normal((1, c, H, HD)).astype(np.float32)
    jk, tk = _as(pk, dtype)
    jv, tv = _as(pv, dtype)
    y_j = jpa.paged_chunk_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt_row), jnp.int32(start), jnp.int32(n_valid),
        window=window, interpret=True)
    y_t = tpa.paged_chunk_attention_ref(
        torch.from_numpy(q), tk, tv, torch.from_numpy(bt_row), start, n_valid, window=window)
    assert y_t.dtype == tk.dtype and tuple(y_t.shape) == (1, c, H, HD)
    a = y_t.float().numpy()[0, :n_valid]  # pad query rows are discarded
    b = np.asarray(y_j.astype(jnp.float32))[0, :n_valid]
    assert _rel_max(a, b) <= 1e-6


def test_paged_token_write_matches_reference():
    """Per-slot token writes land at the same (block, offset) as the
    reference's, inactive rows in the trash block."""
    from repro.models.attention import _paged_token_write as j_write
    from repro_torch.models.attention import _paged_token_write as t_write

    n_blocks, b = 1 + 2 * NB, 2
    pool = np.zeros((n_blocks, BS, KV, HD), np.float32)
    bt = np.array([[3, 5, 0, 0], [1, 2, 4, 6]], np.int32)
    pos = np.array([BS, 2 * BS + 3], np.int32)  # a block boundary and a middle row
    val = np.random.default_rng(5).standard_normal((b, KV, HD)).astype(np.float32)
    for active in (None, np.array([True, False])):
        j = j_write(jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(val),
                    None if active is None else jnp.asarray(active))
        t = t_write(torch.from_numpy(pool.copy()), torch.from_numpy(bt), torch.from_numpy(pos),
                    torch.from_numpy(val), None if active is None else torch.from_numpy(active))
        assert np.array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("m", [1, 3, 32, 37, 130])
def test_plain_fused_partial_dynamic_tile_equals_zero_padding(m):
    """The plain K1 ranges a partial last ``dynamic`` tile over its real
    rows; the reference wrapper pads it with zero rows to ``bm``.  Zero
    rows add exact-zero partial sums to a range clamped at 1e-30, so the
    two give the same bits (noisy slices, some negative), in every ADC
    mode and with a zero input row."""
    from repro_torch.core import DPEConfig
    from repro_torch.core.dpe import prepare_weight
    from repro_torch.core.prng import PRNGKey

    cfg = DPEConfig(array_size=(32, 32))
    g = torch.Generator().manual_seed(m)
    pw = prepare_weight(torch.randn((70, 90), generator=g) * 0.1, cfg, key=PRNGKey(5))
    x = torch.randn((m, 70), generator=g)
    x[m // 2] = 0.0
    for adc in ("dynamic", "dynamic_row", "fullscale"):
        kw = dict(input_spec=cfg.input_spec, weight_spec=cfg.weight_spec, array_size=(32, 32),
                  rdac=cfg.rdac, radc=cfg.radc, adc_mode=adc, bm=32)
        got = tsm.fused_sliced_matmul_ref(x, pw.slices, pw.scale, **kw)
        pad = (-m) % 32 if adc == "dynamic" else 0
        xp = torch.nn.functional.pad(x, (0, pw.slices.shape[1] - 70, 0, pad))
        xs, sx = tsm._prep_input(xp, cfg.input_spec, 32, cfg.rdac)
        want = sliced_matmul_ref(xs, sx, pw.slices, pw.scale, input_spec=cfg.input_spec,
                                 weight_spec=cfg.weight_spec, array_size=(32, 32),
                                 radc=cfg.radc, adc_mode=adc, bm=32 if adc == "dynamic" else m)
        assert torch.equal(got, want[:m]), adc
