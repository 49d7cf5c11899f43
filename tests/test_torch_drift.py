"""Conductance drift and generation refresh in the PyTorch port, against
the JAX reference (mirrors ``tests/test_drift_refresh.py``).

* ``DriftModel``: the reference's validation; ``factor(dt <= 0)`` is
  exactly 1.0; ``factor`` equals the reference's float32 bits as its
  serving steps compute it under ``jit`` (bitwise, both laws, several
  constants).
* Drift off is bitwise off: a published clock changes no bit of a
  ``dpe_apply`` without a model (fast and faithful).
* A drifted fast-mode product equals the reference's bit for bit; the
  plain K1 with a drift factor equals it on the scaled slices (bitwise).
* Drift decays and a re-program restores the fresh output exactly.
* The ``ServeLoop`` under an injected device clock refreshes under live
  traffic: requests admitted before the swap are bitwise those of the
  run without refresh, the request admitted after it decodes generation
  1 (other logits than generation 0's), and every token equals the
  reference ``ServeLoop``'s under the same clock (token-equal).
* ``ServeConfig`` validation and the counter surface.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import DPEConfig as JDPEConfig
from repro.core import DriftModel as JDriftModel
from repro.core import dpe_apply as j_dpe_apply
from repro.core import program_weight as j_program_weight
from repro.core import spec as jspec
from repro.core.layers import MemPolicy as JMemPolicy
from repro.models import init_params as j_init_params
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeLoop as JServeLoop
from repro.serve import ServeReport as JServeReport
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, DriftModel, MemPolicy, drift_clock, spec
from repro_torch.core.dpe import dpe_apply, program_weight, relative_error
from repro_torch.core.prng import PRNGKey, fold_in, normal
from repro_torch.kernels import sliced_matmul as sm
from repro_torch.models import init_params, program_params
from repro_torch.serve import Request, ServeConfig, ServeLoop, ServeReport

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

INT8 = spec("int8")
MODELS = [dict(kind="power", nu=0.05, t0=1.0), dict(kind="power", nu=0.013, t0=3.7),
          dict(kind="power", nu=0.3, t0=0.25), dict(kind="exp", tau=2.5),
          dict(kind="exp", tau=1.0)]


def test_drift_model_validation_and_identity():
    for bad in (dict(kind="banana"), dict(nu=-0.1), dict(t0=0.0), dict(kind="exp", tau=0.0)):
        with pytest.raises(ValueError):
            DriftModel(**bad)
        with pytest.raises(ValueError):
            JDriftModel(**bad)
    m = DriftModel(kind="power", nu=0.1, t0=2.0)
    assert m.factor(0.0) == 1.0 and m.factor(-5.0) == 1.0
    f1, f2 = m.factor(10.0), m.factor(100.0)
    assert 0.0 < f2 < f1 < 1.0
    e = DriftModel(kind="exp", tau=3.0)
    assert e.factor(0.0) == 1.0
    assert e.factor(3.0) == pytest.approx(np.exp(-1.0))
    assert hash(DPEConfig(drift=m)) == hash(DPEConfig(drift=DriftModel(kind="power", nu=0.1,
                                                                          t0=2.0)))


@pytest.mark.parametrize("kw", MODELS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_factor_bits_equal_reference(kw):
    """The float32 factor of 1,500 ages against the reference's jitted
    ``factor`` (how its serving steps evaluate it)."""
    rng = np.random.default_rng(0)
    dts = np.concatenate([rng.random(600) * 10, rng.random(600) * 1e4,
                          rng.random(294) * 1e-3, [0.0, -1.0, 1.0, 2.0, 1e6, 3.7]])
    dts = dts.astype(np.float32)
    ref = jax.jit(JDriftModel(**kw).factor)
    want = np.array([np.asarray(ref(jnp.float32(d))) for d in dts], np.float32)
    got = np.array([DriftModel(**kw).factor(d) for d in dts], np.float32)
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32)), dts[want != got][:5]


def _weights(seed, k=48, n=40, m=4):
    w = normal(PRNGKey(seed), (k, n))
    x = normal(fold_in(PRNGKey(seed), 1), (m, k))
    return w, x


@pytest.mark.parametrize("mode", ["fast", "faithful"])
def test_drift_off_is_bitwise_off(mode):
    cfg = DPEConfig(input_spec=INT8, weight_spec=INT8, array_size=(32, 32), mode=mode,
                    adc_mode="dynamic_row")
    w, x = _weights(7)
    pw = program_weight(w, cfg, key=PRNGKey(2), t_prog=0.0)
    base = dpe_apply(x, pw, 40, cfg)
    with drift_clock(1e4):
        clocked = dpe_apply(x, pw, 40, cfg)
    assert torch.equal(base, clocked)
    drifted = cfg.replace(drift=DriftModel(nu=0.1))
    with drift_clock(0.0):  # age 0: factor exactly 1
        assert torch.equal(base, dpe_apply(x, pw, 40, drifted))


def test_drifted_products_match_reference_and_plain_k1():
    drift = dict(kind="power", nu=0.2, t0=1.0)
    jcfg = JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"), mode="fast",
                      drift=JDriftModel(**drift))
    tcfg = DPEConfig(input_spec=INT8, weight_spec=INT8, mode="fast", drift=DriftModel(**drift))
    w, x = _weights(11)
    jw = j_program_weight(jnp.asarray(w.numpy()), jcfg, jax.random.PRNGKey(3), t_prog=2.0)
    tw = program_weight(w, tcfg, PRNGKey(3), t_prog=2.0)
    assert np.array_equal(np.asarray(jw.w_eff), tw.w_eff.numpy())
    for t in (2.0, 9.5, 300.0):
        want = np.asarray(j_dpe_apply(jnp.asarray(x.numpy()), jw, 40, jcfg, t_now=jnp.float32(t)))
        with drift_clock(t):
            got = dpe_apply(x, tw, 40, tcfg).numpy()
        assert np.array_equal(want, got), t
    # the plain K1 reads the slices times the factor
    fcfg = DPEConfig(input_spec=INT8, weight_spec=INT8, array_size=(32, 32),
                     adc_mode="dynamic_row")
    pw = program_weight(w, fcfg, PRNGKey(4))
    kw = dict(input_spec=INT8, weight_spec=INT8, array_size=(32, 32), rdac=256, radc=1024,
              adc_mode="dynamic_row")
    f = DriftModel(**drift).factor(6.0)
    assert torch.equal(sm.fused_sliced_matmul_ref(x, pw.slices, pw.scale, drift=f, **kw),
                       sm.fused_sliced_matmul_ref(x, pw.slices * torch.tensor(f), pw.scale, **kw))


@pytest.mark.parametrize("mode", ["fast", "faithful"])
def test_drift_decays_and_reprogram_restores(mode):
    cfg = DPEConfig(input_spec=INT8, weight_spec=INT8, mode=mode, array_size=(32, 32),
                    adc_mode="dynamic_row", drift=DriftModel(kind="power", nu=0.3, t0=1.0))
    w, x = _weights(13)
    ideal = x @ w
    pw = program_weight(w, cfg, key=PRNGKey(2), t_prog=0.0)

    def apply(prog, t):
        with drift_clock(t):
            return dpe_apply(x, prog, 40, cfg)

    fresh = apply(pw, 0.0)
    errs = [float(relative_error(apply(pw, t), ideal)) for t in (1.0, 10.0, 100.0)]
    assert errs == sorted(errs) and errs[-1] > 3 * float(relative_error(fresh, ideal))
    pw2 = program_weight(w, cfg, key=PRNGKey(2), t_prog=100.0)
    assert torch.equal(apply(pw2, 100.0), fresh)
    assert torch.equal(dpe_apply(x, pw, 40, cfg), fresh)  # stamped, no clock: no drift


DRIFT = dict(kind="power", nu=0.3, t0=1.0)
WORKLOAD = [(5, 10), (6, 3), (4, 5)]  # A decodes across the swap, C is admitted after it


def _clock():
    # one tick at run() start (t = 1, arms the refresh), then one per
    # iteration: with refresh_every=2.0 the swap fires at t = 3, after A
    # and B are admitted on generation 0 and before C takes B's lane
    c = itertools.count(1)
    return lambda: float(next(c))


@pytest.fixture(scope="module")
def swap_runs():
    jcfg = j_get_smoke("qwen2-0.5b").replace(vocab=64)
    cfg = get_smoke("qwen2-0.5b").replace(vocab=64)
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n, _ in WORKLOAD]
    pol = MemPolicy(default=DPEConfig(input_spec=INT8, weight_spec=INT8, mode="fast",
                                      drift=DriftModel(**DRIFT)))
    sc = ServeConfig(policy=pol, slots=2, max_len=32, compute_dtype=torch.float32,
                     device="cpu", collect_logits=True)
    reqs = [Request(i, p, m) for i, (p, (_, m)) in enumerate(zip(prompts, WORKLOAD))]
    loop = ServeLoop(params, cfg, sc.replace(refresh_every=2.0, clock=_clock()))
    with_swap = loop.run(reqs)
    no_swap = ServeLoop(params, cfg, sc.replace(clock=_clock()),
                        programmed=program_params(params, cfg, pol, PRNGKey(0))).run(reqs)
    jpol = JMemPolicy(default=JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"),
                                         mode="fast", drift=JDriftModel(**DRIFT)))
    ref = JServeLoop(j_init_params(jcfg, jax.random.PRNGKey(0)), jcfg, JServeConfig(
        policy=jpol, slots=2, max_len=32, compute_dtype=jnp.float32, refresh_every=2.0,
        clock=_clock())).run([JRequest(i, p, m) for i, (p, (_, m)) in
                              enumerate(zip(prompts, WORKLOAD))])
    return loop, with_swap, no_swap, ref


def test_refresh_under_live_traffic_no_mid_request_swap(swap_runs):
    loop, with_swap, no_swap, ref = swap_runs
    assert with_swap.reprogram_swaps >= 1 and loop.generation >= 1
    assert no_swap.reprogram_swaps == 0
    assert with_swap.results[2].decode_steps > 0 and with_swap.results[0].decode_steps >= 5
    # in flight across the swap: bitwise the run without refresh
    for i in (0, 1):
        a, b = with_swap.results[i], no_swap.results[i]
        assert a.tokens == b.tokens and len(a.logits) == len(b.logits)
        assert all(np.array_equal(x, y) for x, y in zip(a.logits, b.logits)), i
    # admitted after it: generation 1 (fresh noise fold_in(PRNGKey(0), 1)),
    # so its logits are not the generation-0 run's
    c_swap, c_none = with_swap.results[2], no_swap.results[2]
    assert len(c_swap.tokens) == WORKLOAD[2][1]
    assert not all(np.array_equal(x, y) for x, y in zip(c_swap.logits, c_none.logits))
    # token-equal to the reference ServeLoop under the same clock
    for a, b in zip(with_swap.results, ref.results):
        assert a.tokens == b.tokens, (a.rid, a.tokens, b.tokens)
    assert with_swap.reprogram_swaps == ref.reprogram_swaps


def test_serveconfig_validation_and_counters(swap_runs):
    cfg = get_smoke("qwen2-0.5b")
    with pytest.raises(ValueError):
        ServeConfig(refresh_every=0.0)
    with pytest.raises(ValueError, match="nothing to re-program"):
        ServeLoop({}, cfg, ServeConfig(refresh_every=1.0, device="cpu"))
    assert ServeReport.COUNTER_FIELDS == JServeReport.COUNTER_FIELDS
    with_swap = swap_runs[1]
    assert set(with_swap.counters()) == set(ServeReport.COUNTER_FIELDS)
    assert with_swap.counters()["reprogram_swaps"] == with_swap.reprogram_swaps
