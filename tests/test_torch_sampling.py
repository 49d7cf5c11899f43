"""Sampled decoding of the PyTorch port against the JAX reference.

* ``prng.gumbel`` / ``prng.categorical``: bit-equal to ``jax.random``'s
  (bitwise).
* ``sample_row`` / ``sample_rows``: token-equal to
  ``repro.serve.sampling`` over 2,016 seeded rows of V = 512 with planted
  ties, on the grid temperature {0, 0.5, 1, 2} x top_k {0, 1, 5, 512} x
  top_p {0.1, 0.9, 1.0} (zero mismatches: the softmax's ``exp``, its sum
  and the top-p ``cumsum`` replay XLA's arithmetic and order).
* The ``ServeLoop`` with sampled requests: token-equal to the reference
  ``ServeLoop`` at identical shapes (qwen2-smoke, the reference's weights
  and programmed state carried across; digital and ``mem_fast``).
* The port's own contracts, against its plain versions: sampled batched
  == solo (tokens), and a temperature-0 request == the greedy request
  (tokens and logits, bitwise).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import DPEConfig as JDPEConfig
from repro.core import spec as jspec
from repro.core.layers import MemPolicy as JMemPolicy
from repro.models import init_params as j_init_params
from repro.models import program_params as j_program_params
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeLoop as JServeLoop
from repro.serve import sampling as jsampling
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, prng, spec
from repro_torch.models import convert
from repro_torch.serve import Request, SamplingParams, ServeConfig, ServeLoop
from repro_torch.serve import sampling as tsampling

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

ARRAY = (32, 32)
WORKLOAD = [(11, 5), (5, 4), (7, 5)]  # (prompt_len, max_new_tokens)
LOOP = dict(slots=2, max_len=32, prefill_chunk=8, block_size=8)
KNOBS = [dict(temperature=0.8, top_k=50, top_p=0.95), dict(temperature=1.5, top_k=0, top_p=0.9),
         dict(temperature=0.5, top_k=5, top_p=1.0)]


def policies(kind):
    if kind == "digital":
        return JMemPolicy(default=None), MemPolicy(default=None)
    kw = dict(array_size=ARRAY, mode="fast" if kind == "mem_fast" else "faithful",
              adc_mode="dynamic_row", backend="auto")
    return (
        JMemPolicy(default=JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"), **kw)),
        MemPolicy(default=DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"), **kw)),
    )


@pytest.mark.parametrize("shape", [(5,), (3, 512), (2, 3, 100)])
def test_gumbel_and_categorical_bits_equal_jax(shape):
    rng = np.random.default_rng(len(shape))
    for seed in range(12):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
        g_ref = np.asarray(jax.random.gumbel(key, shape))
        g_got = prng.gumbel(np.asarray(key), shape).numpy()
        assert np.array_equal(g_ref.view(np.uint32), g_got.view(np.uint32)), seed
        logits = (rng.standard_normal(shape) * 2).astype(np.float32)
        c_ref = np.asarray(jax.jit(jax.random.categorical)(key, logits))
        c_got = prng.categorical(np.asarray(key), torch.from_numpy(logits)).numpy()
        assert np.array_equal(c_ref, c_got), seed


def test_request_keys_and_params_match_reference():
    for seed in (0, 5, 2**31 - 1):
        assert np.array_equal(np.asarray(jsampling.request_keys(seed, 9)),
                              tsampling.request_keys(seed, 9))
    for bad in (dict(temperature=-1.0), dict(top_k=-1), dict(top_p=0.0), dict(top_p=1.5)):
        with pytest.raises(ValueError):
            JSamplingParams(**bad)
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    assert tsampling.GREEDY.temperature == 0.0


def test_sample_rows_token_equal_to_reference_over_grid():
    """2,016 rows of V = 512: a third with the max planted in four more
    places, a third with 40 values rounded to integers (ties at the k-th
    value and in the sorted softmax); each row with its own key and a
    point of the knob grid."""
    v = 512
    grid = list(itertools.product((0.0, 0.5, 1.0, 2.0), (0, 1, 5, 512), (0.1, 0.9, 1.0)))
    rng = np.random.default_rng(0)
    n = 2016
    logits = (rng.standard_normal((n, v)) * 3).astype(np.float32)
    for i in range(0, n, 3):
        logits[i, rng.integers(0, v, 4)] = logits[i].max()
    for i in range(1, n, 3):
        j = rng.integers(0, v, 40)
        logits[i, j] = np.round(logits[i, j])
    temps = np.array([grid[i % len(grid)][0] for i in range(n)], np.float32)
    tks = np.array([grid[i % len(grid)][1] for i in range(n)], np.int32)
    tps = np.array([grid[i % len(grid)][2] for i in range(n)], np.float32)
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(i % 97), i))
                     for i in range(n)])
    ref = np.asarray(jax.jit(jsampling.sample_rows)(
        jnp.asarray(keys), jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(tks),
        jnp.asarray(tps)))
    got = tsampling.sample_rows(keys, torch.from_numpy(logits), temps, tks, tps).numpy()
    assert np.array_equal(ref, got), np.flatnonzero(ref != got)
    # the draws are draws: the sampled rows do not collapse onto argmax
    hot = temps > 0
    assert (got[hot] != logits[hot].argmax(-1)).mean() > 0.3
    one = jax.jit(jsampling.sample_row)
    for i in range(0, n, 97):
        assert int(one(jnp.asarray(keys[i]), jnp.asarray(logits[i]), float(temps[i]),
                       int(tks[i]), float(tps[i]))) == tsampling.sample_row(
            keys[i], torch.from_numpy(logits[i]), float(temps[i]), int(tks[i]), float(tps[i]))


@pytest.fixture(scope="module")
def model():
    cfg = j_get_smoke("qwen2-0.5b")
    params = jax.tree.map(np.asarray, j_init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n, _ in WORKLOAD]
    return cfg, params, prompts


def _sampled(req_cls, sp_cls, prompts):
    return [req_cls(i, p, g, sampling=sp_cls(seed=10 + i, **KNOBS[i]))
            for i, (p, (_, g)) in enumerate(zip(prompts, WORKLOAD))]


@pytest.mark.parametrize("kind", ["digital", "mem_fast"])
def test_sampled_serveloop_tokens_match_reference(model, kind):
    jcfg, params_np, prompts = model
    jpol, tpol = policies(kind)
    params_j = jax.tree.map(jnp.asarray, params_np)
    prog_j = j_program_params(params_j, jcfg, jpol, jax.random.PRNGKey(0))
    ref = JServeLoop(params_j, jcfg, JServeConfig(
        policy=jpol, compute_dtype=jnp.float32, **LOOP), programmed=prog_j,
    ).run(_sampled(JRequest, JSamplingParams, prompts))
    loop = ServeLoop(
        convert.params_from_numpy(params_np, "cpu"), get_smoke("qwen2-0.5b"),
        ServeConfig(policy=tpol, compute_dtype=torch.float32, device="cpu", **LOOP),
        programmed=convert.programmed_from_numpy(jax.tree.map(np.asarray, prog_j), "cpu"),
    )
    got = loop.run(_sampled(Request, SamplingParams, prompts))
    for a, b in zip(got.results, ref.results):
        assert a.tokens == b.tokens, (a.rid, a.tokens, b.tokens)


def test_sampled_batched_equals_solo_and_temperature_zero_is_greedy(model):
    _, params_np, prompts = model
    _, tpol = policies("mem_fast")
    cfg = get_smoke("qwen2-0.5b")
    params = convert.params_from_numpy(params_np, "cpu")
    sc = ServeConfig(policy=tpol, compute_dtype=torch.float32, device="cpu",
                     collect_logits=True, **LOOP)
    loop = ServeLoop(params, cfg, sc)
    reqs = _sampled(Request, SamplingParams, prompts)
    batched = loop.run(reqs)
    solo = ServeLoop(params, cfg, sc.replace(slots=1), programmed=loop.programmed)
    for r, res in zip(reqs, batched.results):
        assert res.tokens == solo.run([r]).results[0].tokens
    greedy = loop.run([Request(0, prompts[0], 5)]).results[0]
    cold = loop.run([Request(0, prompts[0], 5, sampling=SamplingParams(temperature=0.0,
                                                                      top_k=3, seed=4))])
    cold = cold.results[0]
    assert cold.tokens == greedy.tokens
    assert all(np.array_equal(a, b) for a, b in zip(cold.logits, greedy.logits))
