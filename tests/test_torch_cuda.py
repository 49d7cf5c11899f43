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

from repro_torch.core import INT8, DPEConfig
from repro_torch.core.dpe import prepare_weight
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sliced_matmul as sm

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
    pw = prepare_weight(w, cfg, key=5)
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
