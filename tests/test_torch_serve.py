"""The port's ``ServeLoop`` against the JAX reference's, greedy.

qwen2-smoke with the reference's random weights and programmed state
carried across; 3 requests through 2 slots with ``prefill_chunk=8`` and
``block_size=8``, so one prompt prefills in two chunks and a lane is
refilled mid-stream.  For each serving policy (digital, ``mem_fast``,
``mem_faithful`` with ``dynamic_row`` ADC) every request emits the
reference's tokens, and the logits agree (max rel 1e-5, faithful rel-Fro
1e-3).  ``mem_fast`` keeps a float32 store here: with bf16 the compiled
reference rounds a product one bf16 ulp away from its own eager run, and
on this workload that flips a near-tie (top-2 margin 3.7e-3; ROADMAP
§C).  Inside the port, a request packed next to strangers emits the same
tokens as alone (batched == solo), bf16 store included.
"""
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
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeLoop as JServeLoop
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec
from repro_torch.models import convert
from repro_torch.serve import Request, ServeConfig, ServeLoop

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

ARRAY = (32, 32)
WORKLOAD = [(11, 4), (5, 3), (7, 4)]  # (prompt_len, max_new_tokens)
LOOP = dict(slots=2, max_len=32, prefill_chunk=8, block_size=8)


def policies(kind):
    if kind == "digital":
        return JMemPolicy(default=None), MemPolicy(default=None)
    kw = dict(array_size=ARRAY, mode="fast" if kind.startswith("mem_fast") else "faithful",
              adc_mode="dynamic_row", store_dtype="bf16" if kind.endswith("bf16") else "f32",
              backend="auto")
    return (
        JMemPolicy(default=JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"), **kw)),
        MemPolicy(default=DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"), **kw)),
    )


@pytest.fixture(scope="module")
def model():
    cfg = j_get_smoke("qwen2-0.5b")
    params = jax.tree.map(np.asarray, j_init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n, _ in WORKLOAD]
    return cfg, params, prompts


def _port_loop(params_np, prog_np, tpol, **kw):
    cfg = get_smoke("qwen2-0.5b")
    params = convert.params_from_numpy(params_np, "cpu")
    prog = convert.programmed_from_numpy(prog_np, "cpu")
    sc = ServeConfig(policy=tpol, compute_dtype=torch.float32, device="cpu",
                     collect_logits=True, **dict(LOOP, **kw))
    return ServeLoop(params, cfg, sc, programmed=prog)


@pytest.mark.parametrize("kind", ["digital", "mem_fast", "mem_faithful"])
def test_serveloop_tokens_match_reference(model, kind):
    jcfg, params_np, prompts = model
    jpol, tpol = policies(kind)
    params_j = jax.tree.map(jnp.asarray, params_np)
    prog_j = j_program_params(params_j, jcfg, jpol, jax.random.PRNGKey(0))
    jloop = JServeLoop(params_j, jcfg, JServeConfig(
        policy=jpol, compute_dtype=jnp.float32, collect_logits=True, **LOOP), programmed=prog_j)
    ref = jloop.run([JRequest(i, p, g) for i, (p, (_, g)) in enumerate(zip(prompts, WORKLOAD))])

    loop = _port_loop(params_np, jax.tree.map(np.asarray, prog_j), tpol)
    got = loop.run([Request(i, p, g) for i, (p, (_, g)) in enumerate(zip(prompts, WORKLOAD))])
    assert got.prefill_chunks_run == ref.prefill_chunks_run == 4
    for a, b in zip(got.results, ref.results):
        assert a.finish_reason == b.finish_reason == "length"
        if a.tokens != b.tokens:
            # report the reference's top-2 margin where the streams part
            i = next(j for j, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y)
            top2 = np.sort(b.logits[i])[-2:]
            pytest.fail(f"request {a.rid} diverges at token {i}: {a.tokens} vs {b.tokens}, "
                        f"reference top-2 margin {top2[1] - top2[0]:.3e}")
        rel = np.linalg.norm(np.asarray(a.logits) - np.asarray(b.logits)) / np.linalg.norm(
            np.asarray(b.logits))
        assert rel <= (1e-3 if kind == "mem_faithful" else 1e-5), rel


@pytest.mark.parametrize("kind", ["mem_fast_bf16", "mem_faithful"])
def test_serveloop_batched_equals_solo(model, kind):
    jcfg, params_np, prompts = model
    _, tpol = policies(kind)
    cfg = get_smoke("qwen2-0.5b")
    params = convert.params_from_numpy(params_np, "cpu")
    loop = ServeLoop(params, cfg, ServeConfig(
        policy=tpol, compute_dtype=torch.float32, device="cpu", **LOOP))
    reqs = [Request(i, p, g) for i, (p, (_, g)) in enumerate(zip(prompts, WORKLOAD))]
    batched = loop.run(reqs)
    solo_loop = ServeLoop(params, cfg, ServeConfig(
        policy=tpol, compute_dtype=torch.float32, device="cpu", **dict(LOOP, slots=1)),
        programmed=loop.programmed)
    for r, res in zip(reqs, batched.results):
        alone = solo_loop.run([r]).results[0]
        assert res.tokens == alone.tokens and len(res.tokens) == r.max_new_tokens


def test_serveloop_programming_per_step_equals_weight_stationary(model):
    """With ``weight_stationary=False`` every step programs its weights on
    the fly from the same per-layer keys, so the loop emits the tokens and
    logits of the loop that programs once, bit for bit."""
    _, params_np, prompts = model
    _, tpol = policies("mem_faithful")
    cfg = get_smoke("qwen2-0.5b")
    params = convert.params_from_numpy(params_np, "cpu")
    reqs = [Request(i, p, g) for i, (p, (_, g)) in enumerate(zip(prompts, WORKLOAD))]
    sc = ServeConfig(policy=tpol, compute_dtype=torch.float32, device="cpu",
                     collect_logits=True, **LOOP)
    once = ServeLoop(params, cfg, sc).run(reqs)
    per_step = ServeLoop(params, cfg, sc.replace(weight_stationary=False))
    assert per_step.programmed is None
    for a, b in zip(once.results, per_step.run(reqs).results):
        assert a.tokens == b.tokens and len(a.tokens) == len(a.logits)
        assert all(np.array_equal(x, y) for x, y in zip(a.logits, b.logits))


def test_unported_serving_features_raise():
    from repro_torch.core import dpe as tdpe
    from repro_torch.models.config import SSMConfig

    with pytest.raises(NotImplementedError):
        ServeConfig(mesh=object())
    _, tpol = policies("mem_faithful")
    # the circuit backend is ported (tests/test_torch_crossbar.py); the
    # lockstep greedy_generate still refuses a mesh
    assert tdpe.resolve_backend(tpol.default.replace(backend="circuit")) == "circuit"
    cfg = get_smoke("qwen2-0.5b")
    from repro_torch.serve import greedy_generate

    with pytest.raises(NotImplementedError, match="mesh"):
        greedy_generate({}, cfg, torch.zeros((1, 2), dtype=torch.int32), 1, mesh=object())
    with pytest.raises(NotImplementedError, match="side inputs"):
        ServeLoop({}, cfg.replace(vision_prefix=4), ServeConfig(device="cpu"))
    with pytest.raises(NotImplementedError, match="all-attention"):
        ServeLoop({}, cfg.replace(family="ssm", ssm=SSMConfig()), ServeConfig(device="cpu"))
    coupled = MemPolicy(default=tpol.default.replace(adc_mode="dynamic"))
    with pytest.raises(ValueError, match="couples"):
        ServeLoop({}, cfg, ServeConfig(policy=coupled, device="cpu"))


def test_prefix_cache_copy_matches_reference():
    """The port's host-side copy of the prefix cache makes the same
    decisions as the reference's on one admit / progress / release
    sequence with shared prefixes."""
    from repro.serve import prefix_cache as jpc
    from repro_torch.serve import prefix_cache as tpc

    rng = np.random.default_rng(3)
    shared = rng.integers(0, 512, 20).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 512, n).astype(np.int32)])
               for n in (5, 9, 0, 13)]
    for p in prompts:
        assert jpc.chain_hashes(p, 8) == tpc.chain_hashes(p, 8)
    caches = (jpc.PrefixCache(12, 8), tpc.PrefixCache(12, 8))
    log = ([], [])
    for side, cache in enumerate(caches):
        plans = []
        for p in prompts:
            plan = cache.admit(p, -(-(len(p) + 4) // 8))
            if plan is None:
                log[side].append(None)
                continue
            cache.register_progress(plan, len(p))
            log[side].append((list(plan.blocks), plan.cached_len, plan.resume_pos, plan.cow))
            plans.append(plan)
            if len(plans) == 2:
                cache.release(plans.pop(0))
        log[side].append((cache.hits, cache.misses, cache.evictions, cache.cow_copies,
                          sorted(cache.free_blocks), sorted(cache.parked_blocks)))
    assert log[0] == log[1]
