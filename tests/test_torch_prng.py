"""The port's keys and random bits (``repro_torch.core.prng``) and XLA's
float32 transcendental functions (``repro_torch.core.xmath``) against
``jax.random`` and ``jax.numpy`` on the CPU.

Keys, bits, uniforms and normals are bitwise equal over several seeds,
fold chains and odd and even shapes; ``choice(replace=False)`` and
``permutation`` give the same indices; noisy programmed slices equal the
reference's bit for bit, because the port also evaluates XLA's ``log``,
``exp`` and ``erf_inv`` in XLA's order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DPEConfig as JDPEConfig
from repro.core import dpe as jdpe
from repro.core import spec as jspec
from repro_torch.core import DPEConfig, spec
from repro_torch.core import dpe as tdpe
from repro_torch.core import prng, xmath

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2**31 - 1]
SHAPES = [(1,), (7,), (4, 6), (3, 5, 7), (129, 33)]


def _chain(key, fold, seed):
    """A fold chain of depth 3 (as the model's segment / layer / name
    keys are) through ``fold``."""
    for d in (seed % 7, 11, 2**31 - 5):
        key = fold(key, d)
    return key


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert np.array_equal(np.asarray(jk), tk)
    jc, tc = _chain(jk, jax.random.fold_in, seed), _chain(tk, prng.fold_in, seed)
    assert np.array_equal(np.asarray(jc), tc)
    for num in (1, 2, 3, 4):
        assert np.array_equal(np.asarray(jax.random.split(jc, num)), prng.split(tc, num))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_normal_bitwise(seed, shape):
    jk = _chain(jax.random.PRNGKey(seed), jax.random.fold_in, seed)
    tk = _chain(prng.PRNGKey(seed), prng.fold_in, seed)
    jb = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    assert np.array_equal(jb, prng.random_bits(tk, shape).numpy())
    assert np.array_equal(np.asarray(jax.random.uniform(jk, shape)),
                          prng.uniform(tk, shape).numpy())
    assert np.array_equal(np.asarray(jax.random.uniform(jk, shape, minval=-3.0, maxval=2.0)),
                          prng.uniform(tk, shape, -3.0, 2.0).numpy())
    assert np.array_equal(np.asarray(jax.random.normal(jk, shape)), prng.normal(tk, shape).numpy())


def test_normal_bitwise_at_scale():
    """One million normals, the tails included (erf_inv's w >= 5 branch)."""
    j = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (1000, 1000)))
    t = prng.normal(prng.PRNGKey(7), (1000, 1000)).numpy()
    differ = int((j != t).sum())
    print(f"normals differing from jax.random.normal: {differ} of {j.size}")
    assert differ == 0


@pytest.mark.parametrize("n", [3, 10, 150, 1000])
def test_choice_and_permutation_equal(n):
    for s in range(3):
        jk, tk = jax.random.PRNGKey(s), prng.PRNGKey(s)
        assert np.array_equal(np.asarray(jax.random.permutation(jk, n)),
                              prng.permutation(tk, n).numpy())
        assert np.array_equal(np.asarray(jax.random.choice(jk, n, (3,), replace=False)),
                              prng.choice(tk, n, (3,)).numpy())


def test_xla_transcendentals_bitwise():
    rng = np.random.default_rng(0)
    y = np.concatenate([rng.uniform(0, 1, 50_000), np.exp(rng.uniform(-18, 3, 50_000))])
    y = y.astype(np.float32)
    assert np.array_equal(np.asarray(jax.jit(jnp.log)(y)), xmath.log(torch.from_numpy(y)).numpy())
    x = rng.uniform(-20, 5, 100_000).astype(np.float32)
    assert np.array_equal(np.asarray(jax.jit(jnp.exp)(x)), xmath.exp(torch.from_numpy(x)).numpy())
    u = rng.uniform(-0.99999, 0.99999, 100_000).astype(np.float32)
    assert np.array_equal(np.asarray(jax.jit(jnp.log1p)(-u * u)),
                          xmath.log1p(torch.from_numpy(-u * u)).numpy())
    assert np.array_equal(np.asarray(jax.jit(jax.lax.erf_inv)(u)),
                          xmath.erf_inv(torch.from_numpy(u)).numpy())


def test_key_checks():
    with pytest.raises(ValueError):
        prng.fold_in(prng.PRNGKey(0), -1)
    with pytest.raises(ValueError):
        prng.PRNGKey(2**40)
    with pytest.raises(ValueError):
        prng.normal(np.zeros(2, np.int64), (3,))


@pytest.mark.parametrize("name", ["int8", "int4"])
@pytest.mark.parametrize("mode", ["faithful", "fast"])
def test_noisy_programming_bitwise(name, mode):
    """Noisy programmed state (every slice draws with ``fold_in(key, s)``)
    equals the reference's eager programming bit for bit."""
    kw = dict(array_size=(32, 32), var=0.05, mode=mode)
    jc = JDPEConfig(input_spec=jspec(name), weight_spec=jspec(name), **kw)
    tc = DPEConfig(input_spec=spec(name), weight_spec=spec(name), **kw)
    w = (np.random.default_rng(1).standard_normal((70, 50)) * 0.1).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(4), 9)
    tkey = prng.fold_in(prng.PRNGKey(4), 9)
    if mode == "faithful":
        a = jdpe.prepare_weight(jnp.asarray(w), jc, key)
        b = tdpe.prepare_weight(torch.from_numpy(w), tc, tkey)
        assert np.array_equal(np.asarray(a.scale), b.scale.numpy())
        assert np.array_equal(np.asarray(a.slices), b.slices.numpy())
    else:
        a = jdpe.fold_weight_noisy(jnp.asarray(w), jc, key)
        b = tdpe.fold_weight_noisy(torch.from_numpy(w), tc, tkey)
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("bits", [1, 4])
def test_program_noise_op_is_reference_round_trip(bits):
    """``ops.program_noise`` on a CPU tensor is the plain round trip (no
    launch) and equals the reference's ``noisy_slice_values``."""
    from repro.core.device import noisy_slice_values as j_noisy
    from repro_torch.kernels import ops

    v = np.random.default_rng(bits).integers(0, 2**bits, (33, 40)).astype(np.float32)
    before = ops.COUNTERS["program_noise"].count
    got = ops.program_noise(prng.PRNGKey(3), torch.from_numpy(v), bits=bits, hgs=1e-5,
                            lgs=1e-7, cv=0.05)
    assert ops.COUNTERS["program_noise"].count == before
    ref = j_noisy(jax.random.PRNGKey(3), jnp.asarray(v), bits, 1e-5, 1e-7, 0.05)
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_fma_rounds_once():
    """``xmath.fma`` where float64 rounding lands halfway between two
    float32 values: ``(1 + 2**-12)**2 ± 2**-80`` must round away from
    the halfway point, as a fused multiply-add does."""
    a = torch.tensor([1 + 2**-12, -(1 + 2**-12), 1 + 2**-12], dtype=torch.float32)
    c = torch.tensor([2**-80, -(2**-80), -(2**-80)], dtype=torch.float32)
    got = xmath.fma(a, a.abs(), c)
    want = np.array([1 + 2**-11 + 2**-23, -(1 + 2**-11 + 2**-23), 1 + 2**-11], np.float32)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("scalar", ["b", "c", "both"])
def test_fma_scalar_operands_equal_tensor_operands(scalar):
    """``xmath.fma`` with a Python float ``b`` and / or ``c`` gives the
    bits of the same call on float32 tensors, halfway cases included:
    ``(1 + 2**-23) + (1 + 2**-15) * 2**-24 * (1 - 2**-15)`` lands on a
    float64 halfway point just above its exact sum (scaled by powers of
    two and signed where ``c`` is a tensor)."""
    rng = np.random.default_rng(5)
    bf, cf = float(np.float32(1 - 2**-15)), float(np.float32(1 + 2**-23))
    scale = 2.0 ** rng.integers(-20, 20, 64) if scalar == "b" else np.ones(64)
    sign = rng.choice([-1.0, 1.0], 64) if scalar == "b" else np.ones(64)
    a = torch.tensor(sign * (1 + 2**-15) * scale * 2**-24, dtype=torch.float32)
    a = torch.cat([a, torch.from_numpy(rng.standard_normal(64).astype(np.float32))])
    b_t = torch.full((128,), bf, dtype=torch.float32)
    c_t = torch.tensor(np.concatenate([sign * scale * cf, np.full(64, cf)]),
                       dtype=torch.float32)
    want = xmath.fma(a, b_t, c_t)
    naive = (a.double() * b_t.double() + c_t.double()).float()
    assert not torch.equal(want, naive)  # the halfway cases are there
    got = xmath.fma(a, bf if scalar != "c" else b_t, cf if scalar != "b" else c_t)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
