"""Core numerics of the PyTorch port against the JAX reference.

The same numpy inputs go through ``repro.core`` (eager JAX on the CPU)
and ``repro_torch.core``.  Integer paths — slicing, block scales at
exact powers of two included, quantisation, the DAC/ADC, input
preparation and noise-free weight programming — are bitwise.

FP specs use a power-of-two block scale ``exp2(floor(log2 absmax) -
(B-2))``.  JAX lowers ``exp2(x)`` to ``exp(x * ln2)``, which misses the
power of two for most integer exponents (``jnp.exp2`` of an array
holding -22. gives 2.38418565e-07, not 2**-22), while the port computes it exactly.  The fp
cases therefore run the reference with its ``exp2`` evaluated exactly
(``_exact_exp2``) and stay bitwise; ``test_reference_exp2_is_inexact``
pins the difference itself.  The
port's programming noise draws JAX's threefry bits
(``repro_torch.core.prng``, held bit for bit against ``jax.random`` by
``tests/test_torch_prng.py``); it is also held against its model here:
mean preserved within 4σ, coefficient of variation within 10%.
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
from repro.core import slicing as jslicing
from repro.core import spec as jspec
from repro_torch.core import DPEConfig, spec
from repro_torch.core import device as tdevice
from repro_torch.core import dpe as tdpe
from repro_torch.core.prng import PRNGKey
from repro_torch.core import quant as tquant
from repro_torch.core import slicing as tslicing

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

SPECS = ["int4", "int8", "int16", "fp16", "bf16"]


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b), float(np.abs(a.astype(np.float64) - b).max())


@contextlib.contextmanager
def _exact_exp2(name):
    """For fp specs, run ``repro.core.quant`` with an exact ``exp2`` of
    its integer exponents (see the module docstring); int specs run the
    reference as it is."""
    if jspec(name).kind != "fp":
        yield
        return
    exact = lambda e: jnp.ldexp(jnp.float32(1), e.astype(jnp.int32))
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.exp2 = exact
    orig = jquant.jnp
    jquant.jnp = proxy
    try:
        yield
    finally:
        jquant.jnp = orig


def test_reference_exp2_is_inexact():
    """The framework difference the fp cases work around: JAX's exp2 of
    an integer is not always the exact power of two; the port's is."""
    e = np.arange(-100, 101, dtype=np.float32)
    exact = np.ldexp(np.float32(1), e.astype(np.int32)).astype(np.float32)
    assert np.array_equal(torch.exp2(torch.from_numpy(e)).numpy(), exact)
    j = np.asarray(jnp.exp2(jnp.asarray(e)))
    assert j[e == -22][0] != np.float32(2.0**-22)
    assert np.all(np.abs(j.astype(np.float64) / exact - 1.0) < 1e-5)


def _inputs(seed, m, k):
    """Random rows, some rescaled so their absmax is an exact power of
    two (where floor(log2 ·) would flip first)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    for r in range(0, m, 2):
        x[r] *= np.float32(2.0 ** (r - 3)) / np.abs(x[r]).max()
    return x


def _cfgs(name, **kw):
    return (
        JDPEConfig(input_spec=jspec(name), weight_spec=jspec(name), **kw),
        DPEConfig(input_spec=spec(name), weight_spec=spec(name), **kw),
    )


@pytest.mark.parametrize("name", SPECS)
def test_slice_int_and_unslice_bitwise(name):
    sp, tsp = jspec(name), spec(name)
    q = np.random.default_rng(0).integers(sp.qmin, sp.qmax + 1, size=(37, 5)).astype(np.int32)
    sl_j = jslicing.slice_int(jnp.asarray(q), sp)
    sl_t = tslicing.slice_int(torch.from_numpy(q), tsp)
    _eq(sl_j, sl_t)
    _eq(jslicing.unslice(sl_j, sp), tslicing.unslice(sl_t, tsp))
    _eq(jslicing.slice_significances(sp), tslicing.slice_significances(tsp))


@pytest.mark.parametrize("name", SPECS)
def test_block_scale_and_quantize_bitwise(name):
    sp, tsp = jspec(name), spec(name)
    rng = np.random.default_rng(1)
    absmax = np.concatenate([
        np.float32(2.0) ** np.arange(-12, 13, dtype=np.float32),
        rng.uniform(1e-3, 50, 64).astype(np.float32),
        np.zeros(2, np.float32),
    ])
    with _exact_exp2(name):
        s_j = jquant.block_scale(jnp.asarray(absmax), sp)
    s_t = tquant.block_scale(torch.from_numpy(absmax), tsp)
    _eq(s_j, s_t)
    x = (rng.standard_normal(absmax.shape) * absmax).astype(np.float32)
    _eq(jquant.quantize(jnp.asarray(x), s_j, sp), tquant.quantize(torch.from_numpy(x), s_t, tsp))


def test_dac_and_adc_bitwise():
    v = np.random.default_rng(2).uniform(0, 15, (64,)).astype(np.float32)
    for rdac, vmax in ((10, 15.0), (256, 15.0), (0, 3.0)):
        _eq(jquant.dac_quantize(jnp.asarray(v), rdac, vmax),
            tquant.dac_quantize(torch.from_numpy(v), rdac, vmax))
    ymax = np.float32(13.0)
    _eq(jquant.adc_quantize(jnp.asarray(v), 1024, jnp.float32(ymax)),
        tquant.adc_quantize(torch.from_numpy(v), 1024, torch.tensor(ymax)))


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("array_size", [(64, 64), (128, 128)])
def test_prepare_input_bitwise(name, array_size):
    jc, tc = _cfgs(name, array_size=array_size, rdac=10)
    x = _inputs(3, 9, 150)
    with _exact_exp2(name):
        xs_j, sx_j = jdpe.prepare_input(jnp.asarray(x), jc)
    xs_t, sx_t = tdpe.prepare_input(torch.from_numpy(x), tc)
    _eq(sx_j, sx_t)
    _eq(xs_j, xs_t)


@pytest.mark.parametrize("name", SPECS)
def test_prepare_weight_noise_off_bitwise(name):
    jc, tc = _cfgs(name, array_size=(64, 64), noise_mode="off")
    w = _inputs(4, 100, 70).T.copy() * 0.1
    with _exact_exp2(name):
        pw_j = jdpe.prepare_weight(jnp.asarray(w), jc)
    pw_t = tdpe.prepare_weight(torch.from_numpy(w), tc)
    _eq(pw_j.scale, pw_t.scale)
    _eq(pw_j.slices, pw_t.slices)


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_fast_pipeline_noise_off_bitwise(store):
    jc, tc = _cfgs("int8", array_size=(64, 64), noise_mode="off", mode="fast", store_dtype=store)
    w = _inputs(5, 90, 80) * 0.05
    x = _inputs(6, 7, 90)
    fw_j = jdpe.fold_weight_noisy(jnp.asarray(w), jc)
    fw_t = tdpe.fold_weight_noisy(torch.from_numpy(w), tc)
    _eq(fw_j.astype(jnp.float32), fw_t.float())
    _eq(jdpe.fake_quant_input(jnp.asarray(x), jc).astype(jnp.float32),
        tdpe.fake_quant_input(torch.from_numpy(x), tc).float())


def test_fast_apply_bf16_store_bitwise_to_eager_reference():
    """``mem_fast`` with its bf16 store, one product end to end: bitwise
    to the eager reference (the compiled reference rounds the bf16
    product differently, by one bf16 ulp, from its own eager run)."""
    jc, tc = _cfgs("int8", array_size=(32, 32), mode="fast", store_dtype="bf16")
    w = _inputs(12, 128, 96) * 0.1
    x = _inputs(13, 8, 128)
    fw = jdpe.program_weight(jnp.asarray(w), jc, jax.random.PRNGKey(1))
    w_eff = np.asarray(fw.w_eff.astype(jnp.float32))
    tw = tdpe.FoldedWeight(torch.from_numpy(w_eff).to(torch.bfloat16))
    y_j = jdpe.dpe_apply(jnp.asarray(x), fw, 96, jc)
    _eq(y_j, tdpe.dpe_apply(torch.from_numpy(x), tw, 96, tc))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_programming_noise_matches_its_model(bits):
    cv, hgs, lgs = 0.05, 1e-5, 1e-7
    n = 200_000
    for level in (0, 2**bits - 1):
        v = torch.full((n,), float(level))
        noisy = tdevice.noisy_slice_values(PRNGKey(12345 + level), v, bits, hgs, lgs, cv)
        g = tdevice.slice_to_conductance(noisy, bits, hgs, lgs).double()
        g0 = lgs + level * (hgs - lgs) / (2.0**bits - 1.0)
        sd = g0 * cv
        assert abs(float(g.mean()) - g0) <= 4 * sd / np.sqrt(n)
        cv_hat = float(g.std() / g.mean())
        assert abs(cv_hat - cv) <= 0.1 * cv, cv_hat
    a = tdevice.noisy_slice_values(PRNGKey(7), torch.ones(16), bits, hgs, lgs, cv)
    b = tdevice.noisy_slice_values(PRNGKey(7), torch.ones(16), bits, hgs, lgs, cv)
    c = tdevice.noisy_slice_values(PRNGKey(8), torch.ones(16), bits, hgs, lgs, cv)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_programming_is_a_pure_function_of_the_key():
    tc = DPEConfig(array_size=(64, 64))
    w = torch.from_numpy(_inputs(7, 70, 50))
    a = tdpe.prepare_weight(w, tc, key=PRNGKey(3))
    b = tdpe.prepare_weight(w, tc, key=PRNGKey(3))
    c = tdpe.prepare_weight(w, tc, key=PRNGKey(4))
    assert torch.equal(a.slices, b.slices) and not torch.equal(a.slices, c.slices)


@pytest.mark.parametrize("adc_mode", ["dynamic", "dynamic_row", "fullscale"])
def test_faithful_engine_matches_seed_loop(adc_mode):
    """The vectorized engine against the seed slice-pair loop (the
    oracle the reference keeps verbatim), noisy weights, rel <= 1e-5."""
    tc = DPEConfig(array_size=(32, 32), adc_mode=adc_mode, backend="xla")
    w = torch.from_numpy(_inputs(8, 70, 50) * 0.1)
    x = torch.from_numpy(_inputs(9, 6, 70))
    pw = tdpe.prepare_weight(w, tc, key=PRNGKey(11))
    xs, sx = tdpe.prepare_input(x, tc)
    a = tdpe._faithful_matmul(xs, sx, pw.slices, pw.scale, tc)
    b = tdpe._faithful_matmul_loop(xs, sx, pw.slices, pw.scale, tc)
    assert float((a - b).norm() / b.norm()) <= 1e-5


def test_faithful_engine_matches_reference_engine():
    """Port vs reference seed loop on the reference's own noisy slices."""
    jc, tc = _cfgs("int8", array_size=(32, 32), adc_mode="fullscale")
    w = _inputs(10, 50, 40) * 0.1
    x = _inputs(11, 5, 50)
    pw = jdpe.prepare_weight(jnp.asarray(w), jc, jax.random.PRNGKey(0))
    xs, sx = jdpe.prepare_input(jnp.asarray(x), jc)
    y_j = np.asarray(jdpe._faithful_matmul_loop(xs, sx, pw.slices, pw.scale, jc))
    t = lambda a: torch.from_numpy(np.asarray(a))
    y_t = tdpe._faithful_matmul_loop(t(xs), t(sx), t(pw.slices), t(pw.scale), tc).numpy()
    assert np.linalg.norm(y_j - y_t) / np.linalg.norm(y_j) <= 1e-5


def test_unported_features_raise():
    from repro_torch.core import prng

    with pytest.raises(NotImplementedError):
        prng.choice(prng.PRNGKey(0), 5, (2,), replace=True)
    # the circuit backend is ported (tests/test_torch_crossbar.py)
    assert tdpe.resolve_backend(DPEConfig(backend="circuit")) == "circuit"
