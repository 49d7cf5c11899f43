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
    # the plain version replays the kernel's fused multiply-add chains,
    # each step rounded once
    assert torch.equal(y, yp), float((y - yp).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_match_plain(card, dtype):
    """K2 and K3 equal their plain versions bit for bit (the served path
    quantises every attention output, so one ulp can move an ADC code)."""
    h, kv, hd, bs, nb, b = 7, 1, 18, 8, 4, 3
    g = torch.Generator(device=card).manual_seed(0)
    n_blocks = 1 + b * nb
    pk = torch.randn((n_blocks, bs, kv, hd), generator=g, device=card).to(dtype)
    pv = torch.randn((n_blocks, bs, kv, hd), generator=g, device=card).to(dtype)
    bt = (torch.randperm(n_blocks - 1, generator=g, device=card)[: b * nb] + 1)
    bt = bt.reshape(b, nb).to(torch.int32).contiguous()
    pos = torch.tensor([0, 13, nb * bs - 1], dtype=torch.int32, device=card)
    q = torch.randn((b, h, hd), generator=g, device=card)
    for window in (0, 4):
        y = pa.paged_decode_attention_cuda(q, pk, pv, bt, pos, window=window)
        yp = pa.paged_decode_attention_ref(q, pk, pv, bt, pos, window=window)
        torch.cuda.synchronize()
        assert torch.equal(y, yp), float((y.float() - yp.float()).abs().max())
    qc = torch.randn((1, 8, h, hd), generator=g, device=card)
    for start, n_valid in ((0, 8), (13, 5)):
        y = pa.paged_chunk_attention_cuda(qc, pk, pv, bt[0], start, n_valid)
        yp = pa.paged_chunk_attention_ref(qc, pk, pv, bt[0], start, n_valid)
        torch.cuda.synchronize()
        a, r = y[0, :n_valid], yp[0, :n_valid]
        assert torch.equal(a, r), float((a.float() - r.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 24])
def test_paged_decode_kernel_served_heads_bitwise(card, dtype, window):
    """K2 at qwen2-0.5b's head layout (14 query heads over 2 KV heads,
    head_dim 64, block size 16): bit-equal to its plain version at pos 0,
    on both sides of a block edge and at the last position; each slot
    alone gives what it gives in the batch."""
    h, kv, hd, bs, nb = 14, 2, 64, 16, 8
    s = nb * bs
    pos_list = [0, bs - 1, bs, 2 * bs + 5, s - 1]
    b = len(pos_list)
    g = torch.Generator(device=card).manual_seed(14 + window)
    n_blocks = 1 + b * nb
    pk = torch.randn((n_blocks, bs, kv, hd), generator=g, device=card).to(dtype)
    pv = torch.randn((n_blocks, bs, kv, hd), generator=g, device=card).to(dtype)
    bt = (torch.randperm(n_blocks - 1, generator=g, device=card)[: b * nb] + 1)
    bt = bt.reshape(b, nb).to(torch.int32)
    for i, p in enumerate(pos_list):  # unmapped tail entries point at the trash block
        bt[i, p // bs + 1:] = 0
    bt = bt.contiguous()
    pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
    q = torch.randn((b, h, hd), generator=g, device=card)
    before = pa.decode_counter.count
    y = ops.paged_decode_attention(q, pk, pv, bt, pos, window=window)
    assert pa.decode_counter.count == before + 1
    yp = pa.paged_decode_attention_ref(q, pk, pv, bt, pos, window=window)
    torch.cuda.synchronize()
    assert y.dtype == dtype and tuple(y.shape) == (b, h, hd)
    assert torch.equal(y, yp), float((y.float() - yp.float()).abs().max())
    for i in range(b):
        solo = pa.paged_decode_attention_cuda(q[i:i + 1].contiguous(), pk, pv,
                                              bt[i:i + 1].contiguous(), pos[i:i + 1].contiguous(),
                                              window=window)
        torch.cuda.synchronize()
        assert torch.equal(solo[0], y[i]), i


# --- K2 / K3 at qwen2-0.5b's heads over long tables ---

SERVED_HEADS = dict(h=14, kv=2, hd=64, bs=16)


def _served_pools(card, dtype, n_blocks, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    shape = (n_blocks, SERVED_HEADS["bs"], SERVED_HEADS["kv"], SERVED_HEADS["hd"])
    pk, pv = (torch.randn(shape, generator=g, device=card).to(dtype) for _ in range(2))
    return pk, pv, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 24])
def test_paged_chunk_kernel_served_heads_bitwise(card, dtype, window):
    """K3 at qwen2-0.5b's head layout, 32-row chunks (all valid, and a
    ragged last chunk of 24), bit-equal to its plain version on the valid
    rows: starting at 0, on both sides of a block edge, at 37 and at
    4,064 (a 4K prompt's last chunk; every score kept) in a 256-block
    table, and at 32,736 (a 32K prompt's last chunk; scores recomputed
    per pass) in a 2,048-block table.  One launch per call."""
    h, hd, c = SERVED_HEADS["h"], SERVED_HEADS["hd"], 32
    for nb, starts in ((256, (0, 15, 16, 37, 4064)), (2048, (32736,))):
        pk, pv, g = _served_pools(card, dtype, nb + 1, nb + window)
        bt_row = (torch.randperm(nb, generator=g, device=card) + 1).to(torch.int32)
        q = torch.randn((1, c, h, hd), generator=g, device=card).to(dtype)
        for start in starts:
            for n_valid in (c, 24):
                before = pa.chunk_counter.count
                y = ops.paged_chunk_attention(q, pk, pv, bt_row, start, n_valid, window=window)
                assert pa.chunk_counter.count == before + 1
                yp = pa.paged_chunk_attention_ref(q, pk, pv, bt_row, start, n_valid,
                                                  window=window)
                torch.cuda.synchronize()
                a, r = y[0, :n_valid], yp[0, :n_valid]
                assert torch.equal(a, r), (nb, start, n_valid, float((a.float() - r.float()).abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 24])
def test_paged_decode_kernel_wide_table_bitwise(card, dtype, window):
    """K2 in a 2,048-block table (qwen2-0.5b's 32,768 positions at block
    size 16): short positions keep every score in shared memory as at a
    16-block table; pos 6,143 lies past the old 5,664-position cap and
    32,767 is the last position, where the scores are recomputed per
    pass.  Bit-equal to the plain version, and each slot alone gives what
    it gives in the batch."""
    h, hd, bs, nb = SERVED_HEADS["h"], SERVED_HEADS["hd"], SERVED_HEADS["bs"], 2048
    pos_list = [0, 17, 255, 6143, 32767]
    b = len(pos_list)
    pk, pv, g = _served_pools(card, dtype, nb + 1, 7 + window)
    bt = torch.stack([torch.randperm(nb, generator=g, device=card) + 1 for _ in range(b)])
    bt = bt.to(torch.int32)
    for i, p in enumerate(pos_list):  # unmapped tail entries point at the trash block
        bt[i, p // bs + 1:] = 0
    bt = bt.contiguous()
    pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
    q = torch.randn((b, h, hd), generator=g, device=card)
    y = ops.paged_decode_attention(q, pk, pv, bt, pos, window=window)
    yp = pa.paged_decode_attention_ref(q, pk, pv, bt, pos, window=window)
    torch.cuda.synchronize()
    assert torch.equal(y, yp), float((y.float() - yp.float()).abs().max())
    for i in range(b):
        solo = pa.paged_decode_attention_cuda(q[i:i + 1].contiguous(), pk, pv,
                                              bt[i:i + 1].contiguous(), pos[i:i + 1].contiguous(),
                                              window=window)
        torch.cuda.synchronize()
        assert torch.equal(solo[0], y[i]), pos_list[i]


_POISON_CU = r"""
#include <cuda_runtime.h>
__global__ void poison_kernel(float v, int n) {
  extern __shared__ float s[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = v;
}
extern "C" int poison_launch(float v, cudaStream_t st) {
  const int bytes = 232448;  // all a block may use on an H100
  cudaFuncSetAttribute(poison_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  poison_kernel<<<132 * 4, 1024, bytes, st>>>(v, bytes / 4);
  return (int)cudaGetLastError();
}
"""


@pytest.fixture(scope="module")
def poison(card, tmp_path_factory):
    """Fill every SM's shared memory with one float value (a throwaway
    kernel built with nvcc), so that a kernel launched next which reads
    shared memory it did not write reads that value."""
    import ctypes
    import subprocess

    from repro_torch.kernels import build

    d = tmp_path_factory.mktemp("poison")
    (d / "poison.cu").write_text(_POISON_CU)
    subprocess.run([build._nvcc(), build.ARCH, "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(d / "poison.so"), str(d / "poison.cu")], check=True)
    lib = ctypes.CDLL(str(d / "poison.so"))
    lib.poison_launch.argtypes = [ctypes.c_float, ctypes.c_void_p]

    def fill(v):
        assert lib.poison_launch(v, torch.cuda.current_stream().cuda_stream) == 0

    return fill


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 24])
def test_paged_kernels_read_only_what_they_write(card, poison, dtype, window):
    """K2 / K3 read no shared memory they did not write: with every SM's
    shared memory filled with NaN, +1e30 or -1e30 before each launch,
    every output equals the unpoisoned one bit for bit, on the path that
    keeps the scores (short positions, a 4K chunk) and on the one that
    recomputes them (pos 6,143 and 32,767; chunks at 6,000 and 32,736) in
    a 2,048-block table, and in a 16-block table (the served shape)."""
    h, hd, bs, nb = SERVED_HEADS["h"], SERVED_HEADS["hd"], SERVED_HEADS["bs"], 2048
    pk, pv, g = _served_pools(card, dtype, nb + 1, 11 + window)
    bt = (torch.randperm(nb, generator=g, device=card) + 1).to(torch.int32)
    btd = torch.stack([bt] * 4).contiguous()
    q = torch.randn((4, h, hd), generator=g, device=card).to(dtype)
    qc = torch.randn((1, 32, h, hd), generator=g, device=card).to(dtype)
    short = torch.randint(0, 256, (4,), generator=g, device=card).to(torch.int32)
    calls = {
        "K2 short, 16-block table": lambda: pa.paged_decode_attention_cuda(
            q, pk, pv, btd[:, :16].contiguous(), short, window=window),
        "K2 short": lambda: pa.paged_decode_attention_cuda(q, pk, pv, btd, short, window=window),
        "K3 start 37": lambda: pa.paged_chunk_attention_cuda(qc, pk, pv, bt, 37, 32, window=window),
        "K3 start 4064": lambda: pa.paged_chunk_attention_cuda(qc, pk, pv, bt, 4064, 32,
                                                                window=window),
        "K3 start 6000": lambda: pa.paged_chunk_attention_cuda(qc, pk, pv, bt, 6000, 32,
                                                                window=window),
        "K3 start 32736": lambda: pa.paged_chunk_attention_cuda(qc, pk, pv, bt, 32736, 32,
                                                                 window=window),
    }
    for p in (6143, 32767):
        pos = torch.full((4,), p, dtype=torch.int32, device=card)
        calls[f"K2 pos {p}"] = (lambda pos=pos: pa.paged_decode_attention_cuda(
            q, pk, pv, btd, pos, window=window))
    for name, call in calls.items():
        want = call().clone()
        for v in (float("nan"), 1e30, -1e30):
            poison(v)
            got = call()
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, v)


def test_serveloop_max_len_invariant_on_card(card):
    """qwen2-smoke through the faithful ServeLoop on the card (K1, K2,
    K3) at ``max_len`` 64 and 2,048: block tables of 8 and 256 entries,
    equal tokens, bit-equal logits."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.core import MemPolicy
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeConfig, ServeLoop

    cfg = get_smoke("qwen2-0.5b")
    params = init_params(cfg, 0, device=card)
    policy = MemPolicy(default=DPEConfig(
        input_spec=INT8, weight_spec=INT8, array_size=(32, 32), mode="faithful",
        adc_mode="dynamic_row", backend="auto"))
    rng = np.random.default_rng(15)
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32), gen)
            for i, (n, gen) in enumerate([(11, 4), (5, 3), (19, 3)])]
    sc = ServeConfig(policy=policy, slots=2, max_len=64, prefill_chunk=8, block_size=8,
                     compute_dtype=torch.float32, device=card, collect_logits=True)
    short = ServeLoop(params, cfg, sc)
    long = ServeLoop(params, cfg, sc.replace(max_len=2048), programmed=short.programmed)
    ops.reset_counters()
    a = short.run(reqs)
    b = long.run(reqs)
    assert ops.COUNTERS["paged_decode_attention"].count > 0
    assert ops.COUNTERS["paged_chunk_attention"].count > 0
    for ra, rb in zip(a.results, b.results):
        assert ra.tokens == rb.tokens and len(ra.logits) == len(rb.logits) > 0
        assert all(np.array_equal(x, y) for x, y in zip(ra.logits, rb.logits))


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
                                   (1, 2, 200, 200, 32), (1, 2, 128, 256, 32),
                                   (1, 14, 1024, 1024, 64)])  # qwen2-0.5b's attention width
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


# --- K1 / K4's cluster decomposition (kernels/sliced_matmul.py::plan_k1) ---

def _k1_both(x, pw, **kw):
    y = sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, **kw)
    yp = sm.fused_sliced_matmul_ref(x, pw.slices, pw.scale, **kw)
    torch.cuda.synchronize()
    return y, yp


@pytest.mark.parametrize("n", [128, 151936 // 8])  # k/v's one n-block; a wide vocab slab
@pytest.mark.parametrize("m", [1, 2, 3, 4, 31, 32, 33, 150])
def test_fused_kernel_served_rows_bitwise(card, n, m):
    """The served configuration (int8 x int8, 128x128, ``dynamic_row``,
    programming noise) at K = 896: one row unit up to 32 rows, a loop of
    units past it, a ragged last unit."""
    cfg = DPEConfig(array_size=(128, 128), adc_mode="dynamic_row")
    pw, g = _programmed(card, cfg, 896, n, m)
    x = torch.randn((m, 896), generator=g, device=card)
    y, yp = _k1_both(x, pw, input_spec=INT8, weight_spec=INT8, array_size=(128, 128), rdac=256,
                     radc=1024, adc_mode="dynamic_row")
    assert torch.equal(y, yp), float((y - yp).abs().max())


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("m,bm", [(3, 128), (33, 16), (40, 32), (64, 64), (150, 64), (150, 150),
                                  (150, 256), (130, 128)])
def test_fused_kernel_dynamic_tiles_bitwise(card, tile, m, bm):
    """``dynamic`` over bm-row tiles: bm < M and bm >= M, tiles padded
    past M (their zero rows count toward the range), one-pass tiles and
    tiles taking a range pass and a quantise pass."""
    cfg = DPEConfig(array_size=(tile, tile), adc_mode="dynamic")
    pw, g = _programmed(card, cfg, 300, 200, m + bm)
    x = torch.randn((m, 300), generator=g, device=card)
    y, yp = _k1_both(x, pw, input_spec=INT8, weight_spec=INT8, array_size=(tile, tile), rdac=256,
                     radc=1024, adc_mode="dynamic", bm=bm)
    assert torch.equal(y, yp), float((y - yp).abs().max())


@pytest.mark.parametrize("adc_mode", ["dynamic", "dynamic_row", "fullscale"])
@pytest.mark.parametrize("m", [1, 2, 32, 70])
def test_fused_kernel_fp32_cluster_bitwise(card, adc_mode, m):
    """fp32 x fp32: 8 x 8 slice pairs, a cluster of 8 CTAs (one per weight
    slice, no column split), 4 rows a thread."""
    cfg = DPEConfig(input_spec=spec("fp32"), weight_spec=spec("fp32"), array_size=(128, 128),
                    adc_mode=adc_mode)
    pw, g = _programmed(card, cfg, 300, 260, m)
    x = torch.randn((m, 300), generator=g, device=card)
    y, yp = _k1_both(x, pw, input_spec=spec("fp32"), weight_spec=spec("fp32"),
                     array_size=(128, 128), rdac=256, radc=1024, adc_mode=adc_mode)
    assert torch.equal(y, yp), float((y - yp).abs().max())


@pytest.mark.parametrize("bm", [32, 64, 128])
def test_staged_kernel_equals_fused_bitwise(card, bm):
    """K4 and K1 run one device code: at equal bm they agree bit for bit."""
    cfg = DPEConfig(adc_mode="dynamic")
    pw, g = _programmed(card, cfg, 1024, 256, bm + 1)
    x = torch.randn((128, 1024), generator=g, device=card)
    xs, sx = prepare_input(x, cfg)
    kw = dict(input_spec=INT8, weight_spec=INT8, array_size=(64, 64), radc=1024,
              adc_mode="dynamic", bm=bm)
    y4 = ops.sliced_matmul(xs, sx, pw.slices, pw.scale, **kw)
    y1 = ops.fused_sliced_matmul(x, pw.slices, pw.scale, rdac=256, **kw)
    yp = sliced_matmul_ref(xs, sx, pw.slices, pw.scale, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y4, yp), float((y4 - yp).abs().max())
    assert torch.equal(y4, y1), float((y4 - y1).abs().max())


@pytest.mark.parametrize("m", [2, 32])
def test_fused_kernel_one_launch_per_call(card, m):
    """The served call (``dynamic_row``, 7 K-blocks) is one kernel launch:
    the counter counts the call, the profiler sees one device kernel, and
    the K-block sum happens inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = DPEConfig(array_size=(128, 128), adc_mode="dynamic_row")
    pw, g = _programmed(card, cfg, 896, 896, m)
    x = torch.randn((m, 896), generator=g, device=card)
    kw = dict(input_spec=INT8, weight_spec=INT8, array_size=(128, 128), rdac=256, radc=1024,
              adc_mode="dynamic_row")
    assert sm.plan_k1(m, 896, 896, 128, 4, 4, "dynamic_row", 128).launches == 1
    sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, **kw)  # build, first-call set-up
    torch.cuda.synchronize()
    before = sm.counter.count
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            y = sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, **kw)
        torch.cuda.synchronize()
    assert sm.counter.count == before + 3
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA and "sliced_matmul" in e.name]
    assert len(kernels) == 3, kernels
    others = [e.name for e in prof.events()
              if e.device_type == DeviceType.CUDA and "sliced_matmul" not in e.name
              and not getattr(e, "is_user_annotation", False)]
    assert not others, others
    assert torch.equal(y, sm.fused_sliced_matmul_ref(x, pw.slices, pw.scale, **kw))


@pytest.mark.parametrize("drift", [0.93, 0.5, 1.0])
@pytest.mark.parametrize("m", [1, 2, 10, 40])
def test_fused_kernel_drift_factor_bitwise(card, drift, m):
    """K1 with a drift factor equals its plain version on the slices times
    the factor, bit for bit, at the decode exchange (M <= 4) and the
    cluster path; a factor of 1 is the undrifted call."""
    cfg = DPEConfig(input_spec=INT8, weight_spec=INT8, array_size=(128, 128),
                    adc_mode="dynamic_row")
    g = torch.Generator(device=card).manual_seed(40 + m)
    w = torch.randn((384, 256), generator=g, device=card) * 384**-0.5
    pw = prepare_weight(w, cfg, key=PRNGKey(8))
    x = torch.randn((m, 384), generator=g, device=card)
    kw = dict(input_spec=INT8, weight_spec=INT8, array_size=(128, 128), rdac=256, radc=1024,
              adc_mode="dynamic_row")
    y = sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, drift=drift, **kw)
    f = torch.tensor(drift, dtype=torch.float32, device=card)
    yp = sm.fused_sliced_matmul_ref(x, pw.slices * f, pw.scale, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, yp), float((y - yp).abs().max())
    if drift == 1.0:
        assert torch.equal(y, sm.fused_sliced_matmul_cuda(x, pw.slices, pw.scale, **kw))


def test_fused_kernel_rows_independent_of_m(card):
    """Under ``dynamic_row`` each row of a K1 call is what the row gives
    alone, at M = 1, 2, 8 and 10 (a speculative verify of 2 slots x 5
    positions), though the launch geometry changes with M."""
    cfg = DPEConfig(input_spec=INT8, weight_spec=INT8, array_size=(128, 128),
                    adc_mode="dynamic_row")
    g = torch.Generator(device=card).manual_seed(77)
    w = torch.randn((896, 640), generator=g, device=card) * 896**-0.5
    pw = prepare_weight(w, cfg, key=PRNGKey(9))
    kw = dict(input_spec=INT8, weight_spec=INT8, array_size=(128, 128), rdac=256, radc=1024,
              adc_mode="dynamic_row")
    x = torch.randn((10, 896), generator=g, device=card)
    alone = torch.cat([sm.fused_sliced_matmul_cuda(x[i:i + 1].contiguous(), pw.slices, pw.scale,
                                                   **kw) for i in range(10)])
    for m in (2, 8, 10):
        y = sm.fused_sliced_matmul_cuda(x[:m].contiguous(), pw.slices, pw.scale, **kw)
        torch.cuda.synchronize()
        assert torch.equal(y, alone[:m]), (m, float((y - alone[:m]).abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_rows_are_single_decodes(card, dtype):
    """A speculative verify's attention (B x C rows through K2, row (b, c)
    at ``pos[b] + c`` in slot b's table) equals C single-row K2 decodes,
    bit for bit; a row past the table's capacity reads its last position
    and stays inside the table."""
    from repro_torch.models.attention import _paged_multi_write

    h, hd, bs, nb, kv, c = SERVED_HEADS["h"], SERVED_HEADS["hd"], SERVED_HEADS["bs"], 8, 2, 5
    pk, pv, g = _served_pools(card, dtype, 2 * nb + 1, 23)
    bt = (torch.randperm(2 * nb, generator=g, device=card) + 1).to(torch.int32).reshape(2, nb)
    pos = torch.tensor([37, nb * bs - 3], dtype=torch.int32, device=card)  # slot 1 runs past
    vals = torch.randn((2, c, kv, hd), generator=g, device=card).to(dtype)
    _paged_multi_write(pk, bt, pos, vals, None)
    _paged_multi_write(pv, bt, pos, vals, None)
    q = torch.randn((2, c, h, hd), generator=g, device=card).to(dtype)
    rows_pos = torch.clamp(pos[:, None] + torch.arange(c, device=card), max=nb * bs - 1)
    y = ops.paged_decode_attention(q.reshape(2 * c, h, hd), pk, pv,
                                   torch.repeat_interleave(bt, c, dim=0).contiguous(),
                                   rows_pos.reshape(-1).to(torch.int32).contiguous())
    for b in range(2):
        for j in range(c):
            one = ops.paged_decode_attention(q[b, j][None].contiguous(), pk, pv,
                                             bt[b][None].contiguous(),
                                             rows_pos[b, j][None].to(torch.int32).contiguous())
            torch.cuda.synchronize()
            assert torch.equal(y[b * c + j], one[0]), (b, j)
    yp = pa.paged_decode_attention_ref(q.reshape(2 * c, h, hd), pk, pv,
                                       torch.repeat_interleave(bt, c, dim=0),
                                       rows_pos.reshape(-1).to(torch.int32))
    assert torch.equal(y, yp)


def test_init_params_on_card_equals_cpu(card):
    """The initial weights drawn on the card are the CPU draw's bits (the
    reference's, ``tests/test_torch_model.py``)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import init_params
    from repro_torch.models.common import tree_leaves

    cfg = get_smoke("qwen2-0.5b")
    for seed in (0, 3):
        a = tree_leaves(init_params(cfg, seed, device=card))
        b = tree_leaves(init_params(cfg, seed, device="cpu"))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y)


def test_norm_rows_independent_of_row_count(card):
    """The norms' row mean gives a row the same bits whatever the number
    of rows (a CUDA ``torch.mean`` over 896 does not, from 8 rows on)."""
    from repro_torch.models.common import rms_norm

    g = torch.Generator(device=card).manual_seed(4)
    x = torch.randn((40, 896), generator=g, device=card)
    s = torch.rand((896,), generator=g, device=card)
    alone = torch.cat([rms_norm(x[i:i + 1], s) for i in range(40)])
    for rows in (2, 8, 10, 40):
        assert torch.equal(rms_norm(x[:rows], s), alone[:rows]), rows
    assert torch.equal(rms_norm(x[:10].reshape(2, 5, 896), s).reshape(10, 896), alone[:10])


def test_speculative_serveloop_equals_plain_on_card(card):
    """qwen2-smoke through the faithful ServeLoop on the card: speculation
    (digital draft, rejections; draft = target, acceptance 1) emits the
    plain decoding's tokens and logits bit for bit, greedy and sampled."""
    import numpy as np

    from repro_torch.configs import get_smoke
    from repro_torch.core import MemPolicy
    from repro_torch.models import init_params
    from repro_torch.serve import Request, SamplingParams, ServeConfig, ServeLoop

    cfg = get_smoke("qwen2-0.5b")
    params = init_params(cfg, 0, device=card)
    policy = MemPolicy(default=DPEConfig(
        input_spec=INT8, weight_spec=INT8, array_size=(32, 32), mode="faithful",
        adc_mode="dynamic_row", backend="auto"))
    rng = np.random.default_rng(16)
    reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32), 6,
                    sampling=SamplingParams(temperature=0.9, top_k=40, seed=i) if i else None)
            for i, n in enumerate((11, 5, 19))]
    sc = ServeConfig(policy=policy, slots=2, max_len=64, prefill_chunk=8, block_size=8,
                     compute_dtype=torch.float32, device=card, collect_logits=True)
    plain = ServeLoop(params, cfg, sc)
    want = plain.run(reqs)
    for draft in (None, policy):
        got = ServeLoop(params, cfg, sc.replace(spec_k=3, draft_policy=draft),
                        programmed=plain.programmed).run(reqs)
        assert got.tokens_drafted > 0
        if draft is not None:
            assert got.acceptance_rate == 1.0
        for a, b in zip(want.results, got.results):
            assert a.tokens == b.tokens, (a.rid, a.tokens, b.tokens)
            assert all(np.array_equal(x, y) for x, y in zip(a.logits, b.logits)), a.rid


@pytest.mark.parametrize("adc_mode,m,tile", [("dynamic", 32, 128), ("dynamic_row", 32, 64),
                                             ("dynamic", 3, 32), ("fullscale", 200, 32)])
def test_stacked_k1_equals_single_and_plain(card, adc_mode, m, tile):
    """K1 over an expert stack, one launch: each expert bit-equal to K1 on
    it alone and to the plain version, zero padding rows and an expert no
    token was routed to included."""
    import numpy as np

    from repro_torch.models import moe

    rng = np.random.default_rng(9)
    cfg = DPEConfig(input_spec=INT8, weight_spec=INT8, array_size=(tile, tile),
                    adc_mode=adc_mode, backend="auto")
    e, k, n = 5, 2 * tile + 7, 3 * tile
    w = torch.from_numpy(rng.standard_normal((e, k, n)).astype(np.float32)).to(card)
    x = torch.from_numpy(rng.standard_normal((e, m, k)).astype(np.float32)).to(card)
    x[2, 1:] = 0.0
    x[3] = 0.0
    prog = moe.program_experts({"wi": w, "wg": w, "wo": w}, cfg, PRNGKey(4))["wi"]
    kw = dict(input_spec=cfg.input_spec, weight_spec=cfg.weight_spec,
              array_size=cfg.array_size, rdac=cfg.rdac, radc=cfg.radc, adc_mode=adc_mode,
              bm=128)
    before = sm.stack_counter.count
    got = ops.fused_sliced_matmul(x, prog.slices, prog.scale, **kw)
    assert sm.stack_counter.count == before + 1
    assert torch.equal(got, ops.fused_sliced_matmul(x, prog.slices, prog.scale,
                                                          kernels=False, **kw))
    for i in range(e):
        assert torch.equal(got[i], ops.fused_sliced_matmul(x[i], prog.slices[i],
                                                           prog.scale[i], **kw)), i


def test_k1_workspace_past_free_memory_raises(card):
    """A K1 call that cannot run in row groups (``dynamic`` with ``bm >=
    M``: one range over the whole call) whose K-block partials (4 B x E x
    nk x M x Np) exceed the card's free memory raises a clear error
    before it allocates, and the next call that fits still runs."""
    m = 16384
    kw = dict(input_spec=INT8, weight_spec=INT8, array_size=(32, 32), rdac=256, radc=1024,
              adc_mode="dynamic", bm=m)
    kp, np_ = 32 * 64, 32 * 1024  # 64 K-blocks: 137 GB of partials
    ws = torch.zeros((4, kp, np_), device=card)
    sw = torch.ones((kp // 32, np_ // 32), device=card)
    x = torch.zeros((m, kp), device=card)
    with pytest.raises(RuntimeError, match="GiB of workspace"):
        sm.fused_sliced_matmul_cuda(x, ws, sw, **kw)
    assert not sm.fused_sliced_matmul_cuda(x[:2], ws, sw, **kw).any()


@pytest.mark.parametrize("adc_mode", ["dynamic", "dynamic_row"])
def test_k1_row_groups_bitwise(card, adc_mode):
    """A stacked K1 call whose K-block partials take more than half of the
    free memory (a filler leaves ~1 GiB; the call's are 1.61 GB) runs in
    row groups, one launch each, on a workspace of its own (the kept one
    stays as it is), and is bit-equal to the same call in one launch (the
    filler freed) and to K1 on each expert alone.  Where the groups fall
    (whole 128-row tiles under ``dynamic``) is held on the CPU
    (``tests/test_torch_k1_plan.py``)."""
    import numpy as np

    from repro_torch.models import moe

    rng = np.random.default_rng(11)
    cfg = DPEConfig(input_spec=INT8, weight_spec=INT8, array_size=(128, 128),
                    adc_mode=adc_mode, backend="auto")
    e, m, k, n = 4, 2048, 4096, 1536  # 32 K-blocks: 4 B x 4 x 32 x 2048 x 1536 of partials
    w = torch.from_numpy(rng.standard_normal((e, k, n)).astype(np.float32)).to(card)
    x = torch.from_numpy(rng.standard_normal((e, m, k)).astype(np.float32)).to(card)
    x[1, 1000:] = 0.0
    prog = moe.program_experts({"wi": w, "wg": w, "wo": w}, cfg, PRNGKey(5))["wi"]
    del w
    kw = dict(input_spec=cfg.input_spec, weight_spec=cfg.weight_spec,
              array_size=cfg.array_size, rdac=cfg.rdac, radc=cfg.radc, adc_mode=adc_mode,
              bm=128)
    before = sm.stack_counter.count
    whole = sm.fused_sliced_matmul_cuda(x, prog.slices, prog.scale, **kw)
    assert sm.stack_counter.count == before + 1
    singles = [sm.fused_sliced_matmul_cuda(x[i], prog.slices[i], prog.scale[i], **kw)
               for i in range(e)]
    sm._workspace.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(card)[0]
    filler = torch.empty(free - 2**30, dtype=torch.uint8, device=card)
    before = sm.stack_counter.count
    got = sm.fused_sliced_matmul_cuda(x, prog.slices, prog.scale, **kw)
    del filler
    assert sm.stack_counter.count - before > 1
    assert sm._workspace[(x.device, torch.cuda.current_stream().cuda_stream)][1] is None
    assert torch.equal(got, whole)
    for i in range(e):
        assert torch.equal(got[i], singles[i]), i


@pytest.mark.parametrize("adc_mode", ["dynamic", "dynamic_row"])
def test_fused_kernel_ragged_vocab_head_bitwise(card, adc_mode):
    """K1 at whisper-tiny's vocab head (384 x 51,865: the weight is
    programmed padded to 406 whole 128-column tiles, the output cut back to
    51,865 columns) equals its plain version bit for bit."""
    from repro_torch.core.dpe import program_weight
    from repro_torch.core.layers import mem_linear

    cfg = DPEConfig(input_spec=INT8, weight_spec=INT8, array_size=(128, 128), mode="faithful",
                    store_dtype="bf16", backend="auto", adc_mode=adc_mode)
    g = torch.Generator(device=card).manual_seed(11)
    w = (torch.rand((384, 51865), generator=g, device=card) - 0.5) * 0.1
    pw = program_weight(w, cfg, PRNGKey(3))
    assert pw.slices.shape[-1] == 406 * 128
    x = torch.randn((4, 384), generator=g, device=card)
    before = sm.counter.count
    y = mem_linear(x, w, None, cfg, None, prepared=pw, kernels=True)
    assert sm.counter.count == before + 1
    yp = mem_linear(x, w, None, cfg, None, prepared=pw, kernels=False)
    torch.cuda.synchronize()
    assert y.shape == (4, 51865)
    assert torch.equal(y, yp), float((y - yp).abs().max())


@pytest.mark.parametrize("arch", ["whisper-tiny", "phi-3-vision-4.2b"])
def test_side_input_smoke_kernels_equal_plain(card, arch):
    """whisper-smoke and phi3-vision-smoke through the launcher's default
    mode under ``mem_faithful``: tokens and every logit row with the
    kernels equal the plain versions' bit for bit."""
    from repro_torch.launch import serve

    args = ["--arch", arch, "--smoke", "--policy", "mem_faithful", "--batch", "2",
            "--prompt_len", "8", "--gen", "2"]
    on = serve.main(args + ["--kernels", "on"], collect_logits=True)
    off = serve.main(args + ["--kernels", "off"], collect_logits=True)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
