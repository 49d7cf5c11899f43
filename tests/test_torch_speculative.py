"""Speculative decoding in the PyTorch port's ``ServeLoop``.

* Against the JAX reference ``ServeLoop`` (qwen2-smoke, its weights and
  programmed state carried across, identical shapes): with ``spec_k=2``
  and the default digital draft, greedy and sampled requests emit the
  reference's tokens (token-equal), for the digital and ``mem_fast``
  targets.
* The port's own contracts, with a faithful target (``dynamic_row``
  ADC, 32x32 arrays, the plain K1 on the CPU, whose rows do not depend on
  the call's row count): speculation with a digital draft (rejections,
  rollback) and with a draft equal to the target (acceptance exactly 1)
  emits bitwise the non-speculative run — tokens and every logit row —
  for greedy and sampled requests sharing a cached prompt prefix; the
  speculative 2-slot run equals the plain 1-slot run (a rolled-back
  neighbour leaves no trace); a batch-coupled draft is refused.

The reference's own packing tests fail on this jax (ROADMAP §C), so none
of this leans on them.
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
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeLoop as JServeLoop
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec
from repro_torch.models import convert, init_params
from repro_torch.serve import Request, SamplingParams, ServeConfig, ServeLoop

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

LOOP = dict(slots=2, max_len=32, prefill_chunk=8, block_size=8)
WORKLOAD = [(11, 4), (5, 3), (7, 4)]
SAMPLED = dict(temperature=0.9, top_k=40, top_p=0.95)


def _cfg(kind, **kw):
    base = dict(array_size=(32, 32), adc_mode="dynamic_row", backend="auto")
    base.update(kw)
    if kind == "mem_fast":
        base["mode"] = "fast"
    return base


def test_spec_serveloop_tokens_match_reference():
    """Greedy and sampled requests through ``spec_k=2`` with the digital
    draft: the reference's tokens, digital and ``mem_fast`` targets."""
    jcfg = j_get_smoke("qwen2-0.5b")
    params_np = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jcfg.vocab, n).astype(np.int32) for n, _ in WORKLOAD]
    for kind in ("digital", "mem_fast"):
        jpol = JMemPolicy(default=None if kind == "digital" else JDPEConfig(
            input_spec=jspec("int8"), weight_spec=jspec("int8"), **_cfg(kind)))
        tpol = MemPolicy(default=None if kind == "digital" else DPEConfig(
            input_spec=spec("int8"), weight_spec=spec("int8"), **_cfg(kind)))
        params_j = jax.tree.map(jnp.asarray, params_np)
        prog_j = j_program_params(params_j, jcfg, jpol, jax.random.PRNGKey(0))
        jsp = [None, JSamplingParams(seed=3, **SAMPLED), None]
        tsp = [None, SamplingParams(seed=3, **SAMPLED), None]
        ref = JServeLoop(params_j, jcfg, JServeConfig(
            policy=jpol, compute_dtype=jnp.float32, spec_k=2, **LOOP), programmed=prog_j,
        ).run([JRequest(i, p, g, sampling=s)
               for i, (p, (_, g), s) in enumerate(zip(prompts, WORKLOAD, jsp))])
        got = ServeLoop(
            convert.params_from_numpy(params_np, "cpu"), get_smoke("qwen2-0.5b"),
            ServeConfig(policy=tpol, compute_dtype=torch.float32, device="cpu", spec_k=2,
                        **LOOP),
            programmed=convert.programmed_from_numpy(jax.tree.map(np.asarray, prog_j), "cpu"),
        ).run([Request(i, p, g, sampling=s)
               for i, (p, (_, g), s) in enumerate(zip(prompts, WORKLOAD, tsp))])
        assert ref.tokens_drafted > 0 and got.tokens_drafted > 0
        for a, b in zip(got.results, ref.results):
            assert a.tokens == b.tokens, (kind, a.rid, a.tokens, b.tokens)


FAITHFUL = MemPolicy(default=DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"),
                                       **_cfg("mem_faithful")))


@pytest.fixture(scope="module")
def served():
    """qwen2-smoke (the reference's weights, drawn by the port), three
    requests sharing a 16-token preamble (prefix-cache hits), two greedy
    and one sampled, served plainly through 2 slots."""
    cfg = get_smoke("qwen2-0.5b")
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(5)
    pre = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab, n).astype(np.int32)])
               for n in (3, 6, 1)]
    samp = [None, SamplingParams(seed=1, **SAMPLED), None]
    reqs = [Request(i, p, 4, sampling=s) for i, (p, s) in enumerate(zip(prompts, samp))]
    sc = ServeConfig(policy=FAITHFUL, compute_dtype=torch.float32, device="cpu",
                     collect_logits=True, **dict(LOOP, max_len=48))
    plain = ServeLoop(params, cfg, sc)
    return cfg, params, sc, plain.programmed, reqs, plain.run(reqs)


def _assert_bitwise(a, b):
    for x, y in zip(a.results, b.results):
        assert x.tokens == y.tokens, (x.rid, x.tokens, y.tokens)
        assert len(x.logits) == len(y.logits)
        assert all(np.array_equal(u, v) for u, v in zip(x.logits, y.logits)), x.rid


@pytest.fixture(scope="module")
def spec_digital(served):
    """The same requests through ``spec_k=2`` with the digital draft."""
    cfg, params, sc, prog, reqs, _ = served
    return ServeLoop(params, cfg, sc.replace(spec_k=2), programmed=prog).run(reqs)


@pytest.mark.parametrize("draft", ["digital", "target"])
def test_spec_equals_plain_bitwise(served, spec_digital, draft):
    cfg, params, sc, prog, reqs, plain = served
    rep = spec_digital if draft == "digital" else ServeLoop(
        params, cfg, sc.replace(spec_k=2, draft_policy=FAITHFUL), programmed=prog,
    ).run(reqs)
    _assert_bitwise(plain, rep)
    assert rep.prefix_cache_hits > 0, "the preamble never hit the cache"
    if draft == "target":
        # the same numerics and noise key: every draft is the target's token
        assert rep.tokens_drafted > 0 and rep.acceptance_rate == 1.0
    else:
        assert rep.tokens_drafted > rep.tokens_accepted > 0  # rollbacks ran
        assert sum(r.acceptance is not None for r in rep.results) > 0


def test_rollback_neighbor_slot_isolation(served, spec_digital):
    """Speculation with rejections next to a neighbour leaves no trace:
    the speculative 2-slot run equals the plain 1-slot run bit for bit."""
    cfg, params, sc, prog, reqs, _ = served
    solo = ServeLoop(params, cfg, sc.replace(slots=1), programmed=prog).run(reqs)
    assert spec_digital.tokens_drafted > spec_digital.tokens_accepted
    _assert_bitwise(solo, spec_digital)


def test_draft_coupling_refused_and_config_validated():
    cfg = get_smoke("qwen2-0.5b")
    coupled = MemPolicy(default=FAITHFUL.default.replace(adc_mode="dynamic"))
    with pytest.raises(ValueError, match="draft_policy couples"):
        ServeLoop({}, cfg, ServeConfig(policy=FAITHFUL, spec_k=2, draft_policy=coupled,
                                       device="cpu"))
    for bad in (dict(spec_k=-1), dict(spec_k=32, max_len=32), dict(draft_policy=FAITHFUL)):
        with pytest.raises(ValueError):
            ServeConfig(device="cpu", **bad)
