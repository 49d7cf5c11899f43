"""The port's IR-drop crossbar model and the circuit backend against the
JAX reference (mirrors ``tests/test_crossbar.py``).

* ``solve_crossbar`` currents and node voltages at the reference test's
  sizes (8, 16, 32): max rel <= 1e-5 to the reference's solve; both
  within 1e-4 of the exact nodal solve (the reference test's bound).
* ``exact_node_voltages``: the reference's float64 solve (max rel
  <= 1e-5; it is the same dense system).
* ``kcl_residual`` on the same node voltages: rel <= 1e-5.  The solve's
  own final residual is a difference of nearly equal currents and is
  held only to its convergence level.
* The reference test's properties: word-line attenuation, the
  no-wire-resistance limit, convergence within 20 sweeps at 1024 x 1024
  (against the reference's 200-sweep solve).
* ``dpe_matmul`` with ``DPEConfig(backend="circuit")`` at M 4, K = N =
  64, 32x32 arrays, programming noise keyed: rel-Fro <= 1e-5 to the
  reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DPEConfig as JDPEConfig
from repro.core import crossbar as jx
from repro.core import dpe as jdpe
from repro_torch.core import DPEConfig, dpe, prng
from repro_torch.core import crossbar as tx

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _case(size, seed=None):
    rng = np.random.default_rng(size if seed is None else seed)
    g = rng.uniform(1e-7, 1e-5, (size, size)).astype(np.float32)
    v = (0.2 * (1 + np.sin(np.arange(size) / size * 6.28))).astype(np.float32)
    return g, v


@pytest.mark.parametrize("size", [8, 16, 32])
def test_solve_matches_reference_and_exact_solve(size):
    g, v = _case(size)
    ref = jx.solve_crossbar(jnp.asarray(g), jnp.asarray(v), 2.93, 30)
    got = tx.solve_crossbar(torch.from_numpy(g), torch.from_numpy(v), 2.93, 30)
    for a, b in ((got.i_out, ref.i_out), (got.vw, ref.vw), (got.vb, ref.vb)):
        assert a.shape == b.shape and rel_max(a.numpy(), b) <= 1e-5
    _, _, i_exact = jx.exact_node_voltages(g, v, 2.93)
    for i_out in (got.i_out.numpy(), np.asarray(ref.i_out)):
        assert np.linalg.norm(i_out - i_exact) / np.linalg.norm(i_exact) < 1e-4
    assert float(got.residual) < 0.05 and float(ref.residual) < 0.05


@pytest.mark.parametrize("size", [8, 16, 32])
def test_exact_node_voltages_match_reference(size):
    g, v = _case(size)
    for a, b in zip(tx.exact_node_voltages(torch.from_numpy(g), torch.from_numpy(v), 2.93),
                    jx.exact_node_voltages(g, v, 2.93)):
        assert rel_max(a, b) <= 1e-5


@pytest.mark.parametrize("size", [8, 16, 32])
def test_kcl_residual_matches_reference(size):
    """On the reference's node voltages after 5 sweeps (far from the
    fixed point, so the residual is not a cancellation)."""
    g, v = _case(size)
    ref = jx.solve_crossbar(jnp.asarray(g), jnp.asarray(v), 2.93, 5)
    gw = np.float32(1.0 / 2.93)
    want = float(jx.kcl_residual(jnp.asarray(g), jnp.asarray(v), gw, ref.vw, ref.vb))
    t = lambda a: torch.from_numpy(np.asarray(a).copy())  # noqa: E731
    got = float(tx.kcl_residual(t(g), t(v), torch.tensor(gw), t(ref.vw), t(ref.vb)))
    assert abs(got - want) <= 1e-5 * want


def test_ir_drop_attenuates_wordline():
    """Fig. 10b: the voltage decays along a word line; the currents sag
    below the ideal dot product (Fig. 10c)."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.uniform(5e-6, 1e-5, (64, 64)).astype(np.float32))
    v = torch.full((64,), 0.2)
    res = tx.solve_crossbar(g, v, 2.93, 30)
    assert bool((res.vw[:, -1] < res.vw[:, 0]).all())
    assert float(res.i_out.sum()) < float(tx.ideal_currents(g, v).sum())


def test_no_wire_resistance_limit():
    """With negligible wire resistance the model reduces to G^T v."""
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.uniform(1e-7, 1e-5, (32, 32)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(0, 0.2, (32,)).astype(np.float32))
    res = tx.solve_crossbar(g, v, 1e-6, 30)
    ideal = tx.ideal_currents(g, v)
    assert float(torch.linalg.norm(res.i_out - ideal) / torch.linalg.norm(ideal)) < 1e-3


def test_convergence_1024_under_20_iters():
    """Paper Fig. 10d: error < 1e-3 within 20 sweeps at 1024x1024, against
    the reference's 200-sweep solve (the port's own 200 sweeps take
    minutes on one CPU thread)."""
    g, _ = _case(1024, seed=2)
    v = (0.2 * (1 + np.sin(np.arange(1024) / 1024 * 6.28))).astype(np.float32)
    ref = np.asarray(jx.solve_crossbar(jnp.asarray(g), jnp.asarray(v), 2.93, 200).i_out)
    got = tx.solve_crossbar(torch.from_numpy(g), torch.from_numpy(v), 2.93, 20).i_out.numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-3


def test_batched_solve_equals_solves_one_by_one():
    """Leading dimensions broadcast: a batch of tiles and inputs (as the
    circuit backend solves them) equals each solve alone, bit for bit."""
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.uniform(1e-7, 1e-5, (2, 1, 8, 6)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(0, 0.2, (1, 3, 8)).astype(np.float32))
    batched = tx.solve_crossbar(g, v, 2.93, 7)
    assert batched.i_out.shape == (2, 3, 6)
    for i in range(2):
        for j in range(3):
            one = tx.solve_crossbar(g[i, 0], v[0, j], 2.93, 7)
            assert torch.equal(batched.i_out[i, j], one.i_out)
            assert torch.equal(batched.residual[i, j], one.residual)


def test_circuit_dpe_matmul_matches_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 64)) * 0.1).astype(np.float32)
    kw = dict(array_size=(32, 32), backend="circuit")
    want = np.asarray(jdpe.dpe_matmul(jnp.asarray(x), jnp.asarray(w), JDPEConfig(**kw),
                                      jax.random.PRNGKey(1)))
    cfg = DPEConfig(**kw)
    assert dpe.resolve_backend(cfg) == "circuit"
    got = dpe.dpe_matmul(torch.from_numpy(x), torch.from_numpy(w), cfg, prng.PRNGKey(1)).numpy()
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5
    # IR-drop is a real departure from the ideal product
    assert np.linalg.norm(got - x @ w) / np.linalg.norm(x @ w) > 1e-2
