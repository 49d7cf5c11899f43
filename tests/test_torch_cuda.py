"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks for the ``card`` fixture, which skips
when no CUDA device is present (the decision is made inside the fixture,
never at import).  On a machine with an H100 and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The first call builds the kernels (``build/torch_kernels/``).  These
tests import no JAX: the plain versions are the oracles here, and they
are held against the JAX reference on the CPU by the other
``test_torch_*`` files.
"""
import pytest
import torch

from repro_torch.core import INT8, DPEConfig, dpe_matmul, spec
from repro_torch.core.dpe import prepare_input, prepare_weight
from repro_torch.core.prng import PRNGKey
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sliced_matmul as sm
from repro_torch.kernels.ref import sliced_matmul_ref

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("adc_mode", ["dynamic", "dynamic_row", "fullscale"])
@pytest.mark.parametrize("m", [1, 5, 130])
def test_fused_sliced_matmul_kernel_matches_plain(card, adc_mode, m):
    cfg = DPEConfig(array_size=(128, 128), adc_mode=adc_mode)
    g = torch.Generator(device=card).manual_seed(m)
    w = torch.randn((300, 200), generator=g, device=card) * 300**-0.5
    pw = prepare_weight(w, cfg, key=PRNGKey(5))
    x = torch.randn((m, 300), generator=g, device=card)
    kw = dict(input_spec=INT8, weight_spec=INT8, array_size=(128, 128), rdac=256, radc=1024,
              adc_mode=adc_mode)
    before = sm.counter.count
    y = ops.fused_sliced_matmul(x, pw.slices, pw.scale, **kw)
    assert sm.counter.count == before + 1
    yp = ops.fused_sliced_matmul(x, pw.slices, pw.scale, kernels=False, **kw)
    assert sm.counter.count == before + 1
    torch.cuda.synchronize()
    # the plain version replays the kernel's fused multiply-add order
    err = float((y.double() - yp.double()).norm() / yp.double().norm())
    assert err <= 1e-6, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_match_plain(card, dtype):
    h, kv, hd, bs, nb, b = 7, 1, 18, 8, 4, 3
    g = torch.Generator(device=card).manual_seed(0)
    n_blocks = 1 + b * nb
    pk = torch.randn((n_blocks, bs, kv, hd), generator=g, device=card).to(dtype)
    pv = torch.randn((n_blocks, bs, kv, hd), generator=g, device=card).to(dtype)
    bt = (torch.randperm(n_blocks - 1, generator=g, device=card)[: b * nb] + 1)
    bt = bt.reshape(b, nb).to(torch.int32).contiguous()
    pos = torch.tensor([0, 13, nb * bs - 1], dtype=torch.int32, device=card)
    q = torch.randn((b, h, hd), generator=g, device=card)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for window in (0, 4):
        y = pa.paged_decode_attention_cuda(q, pk, pv, bt, pos, window=window)
        yp = pa.paged_decode_attention_ref(q, pk, pv, bt, pos, window=window)
        assert float((y.float() - yp.float()).abs().max() / yp.float().abs().max()) <= tol
    qc = torch.randn((1, 8, h, hd), generator=g, device=card)
    for start, n_valid in ((0, 8), (13, 5)):
        y = pa.paged_chunk_attention_cuda(qc, pk, pv, bt[0], start, n_valid)
        yp = pa.paged_chunk_attention_ref(qc, pk, pv, bt[0], start, n_valid)
        a, r = y.float()[0, :n_valid], yp.float()[0, :n_valid]
        assert float((a - r).abs().max() / r.abs().max()) <= tol


def _programmed(card, cfg, k, n, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    w = torch.randn((k, n), generator=g, device=card) * k**-0.5
    return prepare_weight(w, cfg, key=PRNGKey(seed)), g


@pytest.mark.parametrize("tile", [32, 64, 128])
@pytest.mark.parametrize("adc_mode", ["dynamic", "dynamic_row", "fullscale"])
@pytest.mark.parametrize("noise", ["off", "program"])
def test_fused_kernel_every_tile_bitwise(card, tile, adc_mode, noise):
    cfg = DPEConfig(array_size=(tile, tile), adc_mode=adc_mode, noise_mode=noise)
    pw, g = _programmed(card, cfg, 200, 150, tile)
    kw = dict(input_spec=INT8, weight_spec=INT8, array_size=(tile, tile), rdac=256,
              radc=1024, adc_mode=adc_mode)
    for m in (1, 7, 130):
        x = torch.randn((m, 200), generator=g, device=card)
        y = sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, **kw)
        yp = sm.fused_sliced_matmul_ref(x, pw.slices, pw.scale, **kw)
        torch.cuda.synchronize()
        assert torch.equal(y, yp), float((y - yp).abs().max())


@pytest.mark.parametrize("names", [("fp32", "fp32"), ("flex16_5", "flex16_5"),
                                   ("int8", "int4"), ("bf16", "bf16")])
@pytest.mark.parametrize("m", [1, 128])
def test_fused_kernel_presets_bitwise(card, names, m):
    xs, ws = spec(names[0]), spec(names[1])
    cfg = DPEConfig(input_spec=xs, weight_spec=ws)
    pw, g = _programmed(card, cfg, 130, 70, m)
    x = torch.randn((m, 130), generator=g, device=card)
    kw = dict(input_spec=xs, weight_spec=ws, array_size=(64, 64), rdac=256, radc=1024,
              adc_mode="dynamic")
    y = sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, **kw)
    yp = sm.fused_sliced_matmul_ref(x, pw.slices, pw.scale, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, yp), float((y - yp).abs().max())


def test_fused_kernel_refuses_other_tiles(card):
    cfg = DPEConfig(array_size=(16, 16), noise_mode="off")
    pw, g = _programmed(card, cfg, 40, 40, 0)
    with pytest.raises(ValueError, match="square tile"):
        sm.fused_sliced_matmul_cuda(
            torch.randn((2, 40), device=card), pw.slices, pw.scale, input_spec=INT8,
            weight_spec=INT8, array_size=(16, 16), rdac=256, radc=1024, adc_mode="dynamic")


@pytest.mark.parametrize("bm", [32, 64, 128])
@pytest.mark.parametrize("adc_mode", ["dynamic", "dynamic_row", "fullscale"])
def test_staged_kernel_matches_plain_and_fused(card, bm, adc_mode):
    cfg = DPEConfig(adc_mode=adc_mode)
    pw, g = _programmed(card, cfg, 300, 200, bm)
    x = torch.randn((150, 300), generator=g, device=card)
    xs, sx = prepare_input(x, cfg)
    kw = dict(input_spec=INT8, weight_spec=INT8, array_size=(64, 64), radc=1024,
              adc_mode=adc_mode, bm=bm)
    before = sm.staged_counter.count
    y = ops.sliced_matmul(xs, sx, pw.slices, pw.scale, **kw)
    assert sm.staged_counter.count == before + 1
    pad = (-150) % bm
    yp = sliced_matmul_ref(torch.nn.functional.pad(xs, (0, 0, 0, pad)),
                           torch.nn.functional.pad(sx, (0, 0, 0, pad)),
                           pw.slices, pw.scale, **kw)[:150]
    yf = ops.fused_sliced_matmul(x, pw.slices, pw.scale, rdac=256, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, yp), float((y - yp).abs().max())
    ulp = float(yp.abs().max()) * 2.0**-23
    assert float((y - yf).abs().max()) <= 8 * ulp


@pytest.mark.parametrize("shape", [(1, 2, 128, 128, 32), (2, 4, 256, 256, 64),
                                   (1, 2, 200, 200, 32), (1, 2, 128, 256, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(card, shape, causal, dtype):
    b, h, sq, skv, dh = shape
    g = torch.Generator(device=card).manual_seed(sq + skv)
    q, k, v = (torch.randn((b * h, n, dh), generator=g, device=card).to(dtype)
               for n in (sq, skv, skv))
    for window in (0, 64):
        before = fa.counter.count
        y = ops.flash_attention(q, k, v, causal=causal, window=window, bq=64, bk=64)
        assert fa.counter.count == before + 1
        yp = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert y.dtype == dtype
        if dtype == torch.float32:
            assert float((y - yp).abs().max()) <= 2e-5
        else:
            a, r = y.double(), yp.double()
            assert float((a - r).norm() / r.norm()) < 2e-2


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_program_noise_kernel_bitwise(card, bits):
    g = torch.Generator(device=card).manual_seed(bits)
    v = torch.randint(0, 2**bits, (3, 64, 5, 64), generator=g, device=card).float()
    key = PRNGKey(40 + bits)
    kw = dict(bits=bits, hgs=1e-5, lgs=1e-7, cv=0.05)
    before = ops.COUNTERS["program_noise"].count
    y = ops.program_noise(key, v, **kw)
    assert ops.COUNTERS["program_noise"].count == before + 1
    yp = ops.program_noise(key, v, kernels=False, **kw)
    assert torch.equal(y, yp)


def test_fused_kernel_whole_call_range(card):
    """Backend ``xla``: one ``dynamic`` range over all 150 rows."""
    cfg = DPEConfig(array_size=(32, 32), input_spec=spec("int8"), weight_spec=spec("int8"))
    g = torch.Generator(device=card).manual_seed(150)
    x = torch.randn((150, 14), generator=g, device=card)
    w = torch.randn((14, 3), generator=g, device=card)
    before = sm.counter.count
    y = dpe_matmul(x, w, cfg, PRNGKey(11))
    assert sm.counter.count == before + 1
    assert torch.equal(y, dpe_matmul(x, w, cfg, PRNGKey(11), kernels=False))
