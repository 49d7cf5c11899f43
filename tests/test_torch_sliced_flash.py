"""K1 at every crossbar tile, K4 (the staged sliced matmul) and K5 (flash
attention): the port's plain versions against the reference, on the
same numpy inputs.

* K1 and K4 with ideal devices (noise off): the port's plain versions
  equal the reference's oracle (``prepare_input`` + ``sliced_matmul_ref``)
  bit for bit: at 32 / 64 tiles, bm 32 / 64, all three ADC modes, and
  for the fp32, flex16_5 and int8 x int4 presets.  FP specs run the
  reference with an exact ``exp2`` (``test_torch_core.py`` pins why).
* Two gaps are pinned, both with their cause in the reference:
  - its interpret-mode Pallas kernels are not bitwise to its own oracle
    on the same operands: XLA compiles the ADC's ``p / step`` with other
    rounding, and with ideal devices every partial sum is an integer, so
    ``p / step`` often lands exactly on a rounding tie (rel-Fro up to
    ~2e-3 between the reference's kernel and its oracle);
  - with programming noise the ADC turns a last-bit difference of a
    slice-pair sum into a whole code, so two summation orders differ by
    ~1e-4 rel-Fro at M = 64 rows: the reference's own kernel and oracle
    do, on the same noisy operands.  The port's plain version sums in
    its CUDA kernel's order and lies within that spread.
* K5: ``flash_attention_ref`` against ``flash_attention_pallas`` in
  interpret mode at the shapes of ``tests/test_flash_kernel.py``: max
  abs error <= 2e-5 in f32, rel-Fro < 2e-2 in bf16 (the reference's own
  bounds).

Interpret-mode sweeps beyond one case per kernel are marked ``slow``.
"""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DPEConfig as JDPEConfig
from repro.core import dpe as jdpe
from repro.core import quant as jquant
from repro.core import spec as jspec
from repro.kernels import sliced_matmul as jsm
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import sliced_matmul_ref as j_sliced_matmul_ref
from repro_torch.core import spec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import sliced_matmul as tsm
from repro_torch.kernels.ref import sliced_matmul_ref

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def _rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@contextlib.contextmanager
def _exact_exp2(*modules):
    """Run the reference modules with an exact ``exp2`` of integer
    exponents (JAX's is ``exp(x ln 2)``)."""
    exact = lambda e: jnp.ldexp(jnp.float32(1), e.astype(jnp.int32))  # noqa: E731
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.exp2 = exact
    orig = [m.jnp for m in modules]
    for m in modules:
        m.jnp = proxy
    try:
        yield
    finally:
        for m, o in zip(modules, orig):
            m.jnp = o


def _programmed(name, tile, k, n, noise, seed=0):
    cfg = JDPEConfig(input_spec=jspec(name), weight_spec=jspec(name), array_size=(tile, tile),
                     noise_mode="program" if noise else "off")
    w = (np.random.default_rng(seed).standard_normal((k, n)) * 0.1).astype(np.float32)
    with _exact_exp2(jquant):
        pw = jdpe.prepare_weight(jnp.asarray(w), cfg, jax.random.PRNGKey(3))
    return cfg, np.asarray(pw.slices), np.asarray(pw.scale)


# ---------------------------------------------------------------------------
# K1 / K4 with ideal devices: bitwise to the reference's oracle
# ---------------------------------------------------------------------------

def _oracle_case(names, tile, m, bm, adc_mode, noise=False, kernel=False):
    """(port K1 plain, port K4 plain, reference oracle, reference K4
    interpret kernel or None) on one set of operands."""
    xname, wname = names
    cfg = JDPEConfig(input_spec=jspec(xname), weight_spec=jspec(wname), array_size=(tile, tile),
                     noise_mode="program" if noise else "off")
    rng = np.random.default_rng(tile + m + bm)
    w = (rng.standard_normal((90, 70)) * 0.1).astype(np.float32)
    x = rng.standard_normal((m, 90)).astype(np.float32)
    with _exact_exp2(jquant):
        pw = jdpe.prepare_weight(jnp.asarray(w), cfg, jax.random.PRNGKey(3))
        xs, sx = jdpe.prepare_input(jnp.asarray(x), cfg)
    jkw = dict(input_spec=jspec(xname), weight_spec=jspec(wname), array_size=(tile, tile),
               radc=1024, adc_mode=adc_mode, bm=bm)
    jargs = (xs, sx, pw.slices, pw.scale)
    oracle = np.asarray(j_sliced_matmul_ref(*jargs, **jkw))
    ykernel = None
    if kernel:
        ykernel = np.asarray(jsm.sliced_matmul_pallas(*jargs, interpret=True, **jkw))
    t = lambda a: torch.from_numpy(np.asarray(a).copy())  # noqa: E731
    tkw = dict(jkw, input_spec=spec(xname), weight_spec=spec(wname))
    staged = sliced_matmul_ref(*(t(a) for a in jargs), **tkw).numpy()
    # the dispatch point takes the plain version for a CPU tensor
    before = (tsm.counter.count, tsm.staged_counter.count)
    assert np.array_equal(ops.sliced_matmul(*(t(a) for a in jargs), **tkw).numpy(), staged)
    fused = ops.fused_sliced_matmul(t(x), t(pw.slices), t(pw.scale), rdac=cfg.rdac, **tkw).numpy()
    assert (tsm.counter.count, tsm.staged_counter.count) == before
    return fused, staged, oracle, ykernel


@pytest.mark.parametrize("tile,bm,adc_mode", [(32, 32, "dynamic"), (64, 64, "dynamic_row")])
def test_plain_k1_k4_bitwise_to_reference_oracle(tile, bm, adc_mode):
    fused, staged, oracle, _ = _oracle_case(("int8", "int8"), tile, 64, bm, adc_mode)
    assert np.array_equal(staged, oracle)
    assert np.array_equal(fused, oracle)


@pytest.mark.slow
@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("bm", [32, 64])
@pytest.mark.parametrize("adc_mode", ["dynamic", "dynamic_row", "fullscale"])
@pytest.mark.parametrize("names", [("int8", "int8"), ("fp16", "fp16")])
def test_plain_k1_k4_bitwise_sweep(tile, bm, adc_mode, names):
    fused, staged, oracle, _ = _oracle_case(names, tile, 64, bm, adc_mode)
    assert np.array_equal(staged, oracle)
    assert np.array_equal(fused, oracle)


@pytest.mark.slow
@pytest.mark.parametrize("names", [("fp32", "fp32"), ("flex16_5", "flex16_5"), ("int8", "int4")])
def test_plain_k1_presets_bitwise_at_m128(names):
    fused, staged, oracle, _ = _oracle_case(names, 64, 128, 128, "dynamic")
    assert np.array_equal(fused, oracle) and np.array_equal(staged, oracle)


def test_reference_kernel_departs_from_its_oracle_with_ideal_devices():
    """Pinned gap (ROADMAP §C): on the same noise-free operands the
    reference's interpret-mode kernel and its oracle disagree, while the
    port equals the oracle."""
    _, staged, oracle, kernel = _oracle_case(("int8", "int8"), 32, 64, 32, "dynamic",
                                             kernel=True)
    gap = _rel_fro(kernel, oracle)
    print(f"reference kernel vs its oracle, ideal devices: rel-Fro {gap:.2e}")
    assert gap > 1e-5
    assert np.array_equal(staged, oracle)


def test_noisy_adc_codes_follow_the_summation_order():
    """Pinned gap (ROADMAP §C): with programming noise the reference's
    own kernel and oracle differ by more than 1e-5 rel-Fro at M = 64;
    the port's plain version lies within that spread of both."""
    _, staged, oracle, kernel = _oracle_case(("int8", "int8"), 32, 64, 32, "dynamic", noise=True,
                                             kernel=True)
    spread = _rel_fro(kernel, oracle)
    to_kernel, to_oracle = _rel_fro(staged, kernel), _rel_fro(staged, oracle)
    print(f"noisy: kernel vs oracle {spread:.2e}, port vs kernel {to_kernel:.2e}, "
          f"port vs oracle {to_oracle:.2e}")
    assert spread > 1e-5
    assert max(to_kernel, to_oracle) <= 1.01 * spread


def test_staged_ops_pads_rows_to_bm():
    """``ops.sliced_matmul`` pads M to whole ``bm`` tiles with zero rows
    and slices them off, as the reference wrapper does."""
    cfg, slices, scale = _programmed("int8", 32, 90, 70, noise=False)
    x = np.random.default_rng(0).standard_normal((37, 90)).astype(np.float32)
    xs, sx = jdpe.prepare_input(jnp.asarray(x), cfg)
    kw = dict(array_size=(32, 32), radc=1024, adc_mode="dynamic", bm=32)
    xp, sxp = (jnp.pad(a, ((0, 27), (0, 0)) if a.ndim == 2 else ((0, 0), (0, 27), (0, 0)))
               for a in (xs, sx))
    y_j = np.asarray(j_sliced_matmul_ref(
        xp, sxp, jnp.asarray(slices), jnp.asarray(scale), input_spec=jspec("int8"),
        weight_spec=jspec("int8"), **kw))[:37]
    t = lambda a: torch.from_numpy(np.asarray(a).copy())  # noqa: E731
    y_t = ops.sliced_matmul(t(xs), t(sx), t(slices), t(scale), input_spec=spec("int8"),
                            weight_spec=spec("int8"), **kw).numpy()
    assert y_t.shape == (37, slices.shape[2])
    assert np.array_equal(y_t, y_j)


# ---------------------------------------------------------------------------
# K5: flash attention
# ---------------------------------------------------------------------------

SHAPES = [
    (1, 2, 2, 128, 128, 32),
    (2, 4, 2, 256, 256, 64),   # GQA
    (1, 2, 2, 200, 200, 32),   # ragged
    (1, 2, 1, 128, 256, 32),   # cross-length (MQA)
]


def _flash_case(shape, causal, window=0, dtype=jnp.float32):
    b, h, kvh, sq, skv, dh = shape
    rng = np.random.default_rng(sq + skv + dh)
    q = rng.standard_normal((b * h, sq, dh)).astype(np.float32)
    kv = rng.standard_normal((2, b * kvh, skv, dh)).astype(np.float32)
    k, v = (np.repeat(a.reshape(b, kvh, skv, dh), h // kvh, axis=1).reshape(b * h, skv, dh)
            for a in kv)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    out_j = flash_attention_pallas(jq, jk, jv, causal=causal, window=window, bq=64, bk=64,
                                   interpret=True)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tq, tk, tv = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(tdt)
                  for a in (jq, jk, jv))
    before = tfa.counter.count
    out_t = ops.flash_attention(tq, tk, tv, causal=causal, window=window, bq=64, bk=64)
    assert tfa.counter.count == before and out_t.dtype == tdt
    a, r = out_t.float().numpy(), np.asarray(out_j.astype(jnp.float32))
    if dtype == jnp.float32:
        assert np.abs(a - r).max() <= 2e-5
    else:
        assert _rel_fro(a, r) < 2e-2


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_reference_kernel(causal):
    _flash_case(SHAPES[0], causal)


@pytest.mark.slow
@pytest.mark.parametrize("shape,causal", [  # causal only for square self-attention
    (s, c) for s in SHAPES[1:] for c in (True, False) if not c or s[3] == s[4]])
def test_flash_plain_sweep(shape, causal):
    _flash_case(shape, causal)


def test_flash_plain_window_and_bf16():
    _flash_case((1, 2, 2, 256, 256, 32), True, window=64)
    _flash_case((1, 2, 2, 128, 128, 32), True, dtype=jnp.bfloat16)


def test_flash_cuda_wrapper_refuses_other_tiles():
    """The kernel's tiles are 64 x 64; the wrapper raises on any other,
    before it looks at the tensors."""
    assert tfa.TILES == (64,)
    q = torch.zeros((2, 8, 32))
    for bq, bk in ((128, 64), (64, 128), (32, 32)):
        with pytest.raises(ValueError, match=f"bq={bq} / bk={bk}"):
            tfa.flash_attention_cuda(q, q, q, bq=bq, bk=bk)


def test_flash_cuda_wrapper_refuses_cpu_tensors():
    q = torch.zeros((2, 8, 32))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tsm.staged_sliced_matmul_cuda(
            torch.zeros((4, 32, 32)), torch.zeros((32, 1)), torch.zeros((4, 32, 32)),
            torch.zeros((1, 1)), input_spec=spec("int8"), weight_spec=spec("int8"),
            array_size=(32, 32), radc=1024, adc_mode="dynamic", bm=32)
