"""The paper's applications (``repro_torch.apps``) against the reference
apps (``repro.apps``) on the CPU, with the same arguments at a small
size, and the straight-through ``mem_matmul``.

Tolerances: error scalars (``matmul_re``, ``monte_carlo``, ``cwt``) rel
<= 1e-4; ``linsolve`` residual histories rel <= 1e-3 in norm; K-means
assignments, the CWT peak scale and the MLP accuracies (as counts of
hits) equal; ``train_mlp`` losses per step rel <= 1e-4 (2 formats, 10
steps); the STE's gradients rel-Fro <= 1e-6 against ``jax.grad`` of the
reference's ``mem_matmul``.  Every app runs the reference as it is,
on its default engine (backend ``xla``), whose ``dynamic`` ADC range
spans all rows of a call; the port's default ranges the same way.

``linsolve``'s solvers add in XLA's CPU order, so its software residuals
are bitwise the reference's.  The whole-app runs
(seconds each, mostly the reference's eager JAX) are marked ``slow``;
the CWT, the training run and the STE run always.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import cwt as jcwt
from repro.apps import inference_sweep as jsweep
from repro.apps import kmeans as jkmeans
from repro.apps import linsolve as jlin
from repro.apps import matmul_re as jmre
from repro.apps import monte_carlo as jmc
from repro.apps import train_mlp as jtrain
from repro.core import DPEConfig as JDPEConfig
from repro.core import spec as jspec
from repro.core.layers import mem_matmul as j_mem_matmul
from repro_torch.apps import cwt, inference_sweep, kmeans, linsolve, matmul_re, monte_carlo
from repro_torch.apps import train_mlp
from repro_torch.core import DPEConfig, dpe_matmul, spec
from repro_torch.core.layers import mem_matmul
from repro_torch.core.prng import PRNGKey

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.slow
def test_matmul_re_matches_reference():
    got, ref = matmul_re.run(n=64, device="cpu"), jmre.run(n=64)
    assert got.keys() == ref.keys()
    for k in ref:
        assert _rel(got[k], ref[k]) <= 1e-4, (k, got[k], ref[k])


@pytest.mark.slow
def test_monte_carlo_matches_reference():
    kw = dict(n=64, cycles=2, variations=(0.0, 0.05), blocks=(32, 64))
    got, ref = monte_carlo.run(device="cpu", **kw), jmc.run(**kw)
    assert got.keys() == ref.keys()
    for k in ref:
        assert _rel(got[k][0], ref[k][0]) <= 1e-4, (k, got[k], ref[k])


def test_cwt_matches_reference():
    got, ref = cwt.run(n=256, n_scales=12, device="cpu"), jcwt.run(n=256, n_scales=12)
    assert _rel(got["power_re"], ref["power_re"]) <= 1e-4
    assert got["peak_scale_match"] == ref["peak_scale_match"]


@pytest.mark.slow
def test_kmeans_matches_reference_kernel_path():
    """M = 150 rows per call: the one app past a 128-row tile, so it
    shows that the port's default ranges ``dynamic`` over the whole call
    as the reference's default does."""
    got = kmeans.run(iters=10, device="cpu")
    x, labels = jkmeans.iris_like()
    x = (x - x.mean(0)) / x.std(0)
    cfg = JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"), var=0.05)
    hw = lambda a, b: jkmeans.dpe_matmul(a, b, cfg, jax.random.PRNGKey(11))  # noqa: E731
    _, hw_assign = jkmeans.kmeans(x, 3, hw, 10)
    _, sw_assign = jkmeans.kmeans(x, 3, lambda a, b: a @ b, 10)
    assert np.array_equal(got["hw_assign"], np.asarray(hw_assign))
    assert np.array_equal(got["sw_assign"], np.asarray(sw_assign))
    assert got["hw_vs_sw_agreement"] == jkmeans._agree(hw_assign, sw_assign)
    assert got["hw_vs_truth"] == jkmeans._agree(hw_assign, labels)


@pytest.fixture(scope="module")
def port_linsolve():
    return linsolve.run(device="cpu")


@pytest.mark.slow
def test_linsolve_matches_reference(port_linsolve):
    got, ref = port_linsolve, jlin.run()
    assert _rel(got["cond"], ref["cond"]) <= 1e-5
    for k in ("sw_residuals", "hw_residuals"):
        assert len(got[k]) == len(ref[k])
        assert _rel_norm(got[k], ref[k]) <= 1e-3, k
    # exact matvecs and XLA's reduction order: the same bits
    assert got["sw_residuals"] == ref["sw_residuals"]
    assert got["sw_err"] <= 1e-5 and ref["sw_err"] <= 1e-5
    print(f"hw_err: port {got['hw_err']:.9e}, reference {ref['hw_err']:.9e} "
          f"(rel {_rel(got['hw_err'], ref['hw_err']):.2e})")
    assert _rel(got["hw_err"], ref["hw_err"]) <= 1e-3


@pytest.mark.slow
def test_linsolve_hw_err_follows_solver_rounding(port_linsolve):
    """The port's solvers round as the reference's: driven by the port's
    matvec, the reference's refinement gives the port's residual history
    bit for bit.  ``hw_err`` then differs only through the exact
    solution (``torch.linalg.solve`` and ``jnp.linalg.solve`` differ by
    one ulp in some elements), far inside 1e-4.  The analog matvecs
    themselves differ in the last bits (the reference's FP block scale,
    ROADMAP §C, and its jitted matvec's fusions), which is what is left
    of the ``hw_err`` gap in ``test_linsolve_matches_reference``."""
    got = port_linsolve
    a, b = jlin.wordline_system(8)
    ta = torch.from_numpy(np.asarray(a).copy())
    cfg = DPEConfig(input_spec=spec("fp32"), weight_spec=spec("fp32"), var=0.05,
                    array_size=(32, 32))

    def port_matvec(v):
        v = torch.from_numpy(np.asarray(v).copy())[None, :]
        return jnp.asarray(dpe_matmul(v, ta, cfg, PRNGKey(7))[0].numpy())

    x_hw, hist = jlin.refine_solve(a, b, port_matvec, outers=12, inners=8)
    assert hist == got["hw_residuals"]
    exact = jnp.linalg.solve(a, b)
    hw_err = float(jnp.linalg.norm(x_hw - exact) / jnp.linalg.norm(exact))
    assert _rel(got["hw_err"], hw_err) <= 1e-4


@pytest.mark.parametrize("fmt", ["int8", "fp16"])
def test_train_mlp_matches_reference(fmt):
    """Every one of 10 steps' loss of fast-mode training (the reference's
    jitted loss and hand-written momentum SGD), then the test accuracy."""
    cfg = JDPEConfig(input_spec=jspec(fmt), weight_spec=jspec(fmt), var=0.05, mode="fast")
    x_train, y_train = jtrain.synth_digits(120, seed=0)
    x_test, y_test = jtrain.synth_digits(30, seed=1)
    params = jtrain.init_net(jax.random.PRNGKey(0))

    @jax.jit
    def loss_fn(p, xb, yb, key):
        logp = jax.nn.log_softmax(jtrain.forward(p, xb, cfg, key))
        return -jnp.mean(jnp.take_along_axis(logp, yb[:, None], axis=1))

    mom = jax.tree.map(jnp.zeros_like, params)
    ref = []
    for step in range(10):
        i = (step * 64) % (x_train.shape[0] - 64)
        key = jax.random.fold_in(jax.random.PRNGKey(5), step)
        loss, g = jax.value_and_grad(loss_fn)(params, x_train[i:i + 64], y_train[i:i + 64], key)
        mom = jax.tree.map(lambda m, gg: 0.9 * m + gg, mom, g)
        params = jax.tree.map(lambda p, m: p - 0.05 * m, params, mom)
        ref.append(float(loss))
    logits = jtrain.forward(params, x_test, cfg, jax.random.PRNGKey(123))
    ref_hits = int((jnp.argmax(logits, 1) == y_test).sum())

    got = train_mlp.run(formats=(fmt,), steps=10, device="cpu")[fmt]
    assert len(got["losses"]) == 10
    for step, (a, b) in enumerate(zip(got["losses"], ref)):
        assert _rel(a, b) <= 1e-4, (fmt, step, a, b)
    assert got["first_loss"] == got["losses"][0] and got["final_loss"] == got["losses"][-1]
    assert round(got["test_acc"] * len(y_test)) == ref_hits


@pytest.mark.slow
def test_inference_sweep_matches_reference():
    kw = dict(bit_range=(3, 5), variations=(0.0, 0.05))
    got, ref = inference_sweep.run(device="cpu", **kw), jsweep.run(**kw)
    n = 240
    assert round(got["fp_acc"] * n) == round(ref["fp_acc"] * n)
    for k in ("acc_by_bits", "acc_by_var"):
        assert got[k].keys() == ref[k].keys()
        for b in ref[k]:
            assert abs(got[k][b] - ref[k][b]) <= 1e-9, (k, b)


@pytest.mark.parametrize("mode", ["fast", "faithful"])
def test_mem_matmul_straight_through_gradients(mode):
    kw = dict(array_size=(32, 32), var=0.05, mode=mode)
    jc = JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"), **kw)
    tc = DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"), **kw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 40)).astype(np.float32)
    w = (rng.standard_normal((40, 24)) * 0.2).astype(np.float32)
    g = rng.standard_normal((2, 5, 24)).astype(np.float32)
    key = jax.random.PRNGKey(9)

    def obj(xx, ww):
        return jnp.sum(j_mem_matmul(xx, ww, key, jc) * g)

    jgx, jgw = jax.grad(obj, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = mem_matmul(tx, tw, PRNGKey(9), tc)
    assert y.dtype == tx.dtype and tuple(y.shape) == (2, 5, 24)
    (y * torch.from_numpy(g)).sum().backward()
    assert _rel_norm(tx.grad.numpy(), jgx) <= 1e-6
    assert _rel_norm(tw.grad.numpy(), jgw) <= 1e-6
    # the forward is the DPE, the backward the full-precision product
    assert _rel_norm(y.detach().numpy(), np.asarray(j_mem_matmul(jnp.asarray(x), jnp.asarray(w),
                                                                  key, jc))) <= 1e-5
