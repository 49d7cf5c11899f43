"""The port's MoE models on its serving paths against the JAX reference:
qwen3-moe-smoke (2 layers, 8 experts top 2) and kimi-k2-smoke (2 layers,
12 experts top 3), the reference's weights (``init_params`` draws them
bit for bit), float32.

Hardware policies: int8 x int8 on 32x32 arrays, ``dynamic_row`` ADC,
float32 store, backend ``auto``, the router digital; both sides serve
ONE programmed state, the port's (the reference's compiled programming
departs from its eager one, ROADMAP §C).  Classes:

* ``forward`` in prefill mode (digital): hidden states and K / V max rel
  <= 1e-5; a dense ``decode_step`` from each side's prefill cache,
  logits max rel <= 1e-5;
* ``greedy_generate`` (batch 2, prompt 8, 3 new): tokens equal for digital,
  ``mem_fast`` and ``mem_faithful``; the first-token logits max rel
  <= 1e-5 (digital), rel-Fro <= 1e-5 (fast) and 1e-3 (faithful);
* the paged ``ServeLoop`` (3 requests through 2 slots, prefill chunk 8,
  block 8) against the reference's at the same chunk size (an MoE row's
  capacity depends on the chunk, so the chunk size is part of the
  result): tokens equal, the faithful logits rel-Fro <= 2e-2 a row
  (``LOOP_FAITHFUL``);
* one speculative run (``spec_k`` 2, digital draft) with an MoE target
  (qwen3-moe-smoke): the reference's tokens;
* the launcher ``--smoke --arch qwen3-moe-235b-a22b --policy
  mem_faithful`` (``make_policy``: 128x128 arrays, ``dynamic`` ADC) in
  its default mode: tokens equal the reference launcher's, each side
  programming its own crossbars.

The port's own contracts: a request packed next to strangers decodes
as alone, tokens and logits (batched == solo: a row's choices go
to distinct experts, C >= 8 >= k, and ``dynamic_row`` ranges each row
alone); the launcher's ``--requests`` ranges the expert stacks per row;
the trainer trains both smoke configs (``test_trainer_refuses_moe``,
named when the trainer refused MoE layers): ``loss_fn`` on 16 tokens and
its gradients against the reference's jitted ``value_and_grad`` (loss
within rel 1e-5; every gradient within max rel 1e-4), and ``python -m
repro_torch.launch.train --arch <arch> --smoke`` (2 steps, batch 2 x 16)
against the reference's launcher, every loss within rel 1e-5;
``tests/test_torch_moe_train.py`` holds the rest of training.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import DPEConfig as JDPEConfig
from repro.core import dpe as jdpe
from repro.core import spec as jspec
from repro.core.layers import MemPolicy as JMemPolicy
from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models.model import decode_step as j_decode_step
from repro.models.model import forward as j_forward
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeLoop as JServeLoop
from repro.serve import greedy_generate as j_greedy_generate
from repro.serve.engine import make_prefill_step as j_make_prefill_step
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec
from repro_torch.core import dpe as tdpe
from repro_torch.launch import serve, train
from repro_torch.launch.dryrun import make_policy
from repro_torch.models import decode_step, forward, init_params, loss_fn, program_params
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.serve import Request, ServeConfig, ServeLoop, greedy_generate
from repro_torch.serve.engine import make_prefill_step

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

ARCHS = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"]
KINDS = ["digital", "mem_fast", "mem_faithful"]
GEN = 3
LOGIT_CLASS = {"digital": 1e-5, "mem_fast": 1e-5, "mem_faithful": 1e-3}
# the ServeLoop's faithful logits, rel-Fro per row: the digital parts'
# last-bit differences (attention, norms, the router's dot) move a whole
# int8 input code or a near-tie expert choice now and then: 1.04e-2 on
# one of 11 qwen3-moe-smoke rows (the others <= 2.1e-4), tokens equal
LOOP_FAITHFUL = 2e-2
WORKLOAD = [(11, 3), (5, 2), (7, 3)]  # (prompt_len, max_new_tokens)
LOOP = dict(slots=2, max_len=32, prefill_chunk=8, block_size=8)


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def policies(kind):
    """(reference, port) policy: every projection on the DPE, the router
    digital."""
    if kind == "digital":
        return JMemPolicy(default=None), MemPolicy(default=None)
    kw = dict(array_size=(32, 32), mode="fast" if kind == "mem_fast" else "faithful",
              adc_mode="dynamic_row", backend="auto")
    return (
        JMemPolicy(default=JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"), **kw),
                   overrides=(("router", None),)),
        MemPolicy(default=DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"), **kw),
                  overrides=(("router", None),)),
    )


def to_reference(tree):
    """The port's programmed state as the reference's (untimed) tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_reference(v) for k, v in tree.items()}
    if isinstance(tree, tdpe.PreparedWeight):
        return jdpe.PreparedWeight(jnp.asarray(tree.slices.numpy()),
                                   jnp.asarray(tree.scale.numpy()))
    return jdpe.FoldedWeight(jnp.asarray(tree.w_eff.numpy()))


def agree(kind, got, want, faithful=LOGIT_CLASS["mem_faithful"]):
    err = rel_max(got, want) if kind == "digital" else rel_fro(got, want)
    assert err <= (faithful if kind == "mem_faithful" else LOGIT_CLASS[kind]), (kind, err)


@functools.lru_cache(maxsize=None)
def build(arch):
    """Both sides' weights, the port's programmed states (and the
    reference's copy of them), prompts and requests of one arch."""
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    params = init_params(cfg, 0, device="cpu")
    progs = {kind: program_params(params, cfg, policies(kind)[1]) for kind in KINDS}
    rng = np.random.default_rng(1)
    return dict(arch=arch, jcfg=jcfg, jparams=j_init_params(jcfg, jax.random.PRNGKey(0)),
                cfg=cfg, params=params, prompts=prompts, progs=progs,
                jprogs={k: to_reference(v) for k, v in progs.items()},
                requests=[rng.integers(0, cfg.vocab, n).astype(np.int32) for n, _ in WORKLOAD],
                served={})


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return build(request.param)


def test_forward_prefill_and_decode_step_match_reference(model):
    m = model
    batch = {"tokens": jnp.asarray(m["prompts"])}
    jh, jst = jax.jit(lambda p, b: j_forward(p, m["jcfg"], b, mode="prefill",
                                             compute_dtype=jnp.float32))(m["jparams"], batch)
    h, st = forward(m["params"], m["cfg"], {"tokens": torch.from_numpy(m["prompts"])},
                    mode="prefill", compute_dtype=torch.float32)
    assert rel_max(h.numpy(), jh) <= 1e-5
    for k in ("k", "v"):
        assert rel_max(st["seg0"][k].numpy(), jst["seg0"][k]) <= 1e-5
    jpol, tpol = policies("digital")
    _, jcache = jax.jit(j_make_prefill_step(m["jcfg"], jpol, compute_dtype=jnp.float32,
                                            cache_dtype=jnp.float32))(m["jparams"], batch)
    tok = np.array([3, 77], np.int32)
    jlogits, _ = jax.jit(lambda p, c, t: j_decode_step(p, m["jcfg"], c, t, policy=jpol,
                                                       compute_dtype=jnp.float32))(
        m["jparams"], jcache, jnp.asarray(tok))
    _, cache = make_prefill_step(m["cfg"], tpol, compute_dtype=torch.float32,
                                 cache_dtype=torch.float32)(
        m["params"], {"tokens": torch.from_numpy(m["prompts"])})
    logits, cache = decode_step(m["params"], m["cfg"], cache, torch.from_numpy(tok),
                                compute_dtype=torch.float32)
    assert cache["pos"].tolist() == [9, 9]
    assert rel_max(logits.numpy(), jlogits) <= 1e-5


@pytest.mark.parametrize("kind", KINDS)
def test_greedy_generate_matches_reference(model, kind):
    m = model
    jpol, tpol = policies(kind)
    jprog = m["jprogs"][kind]
    want = np.asarray(j_greedy_generate(m["jparams"], m["jcfg"], jnp.asarray(m["prompts"]), GEN,
                                        policy=jpol, compute_dtype=jnp.float32,
                                        programmed=jprog))
    first, _ = jax.jit(j_make_prefill_step(m["jcfg"], jpol, compute_dtype=jnp.float32,
                                           cache_dtype=jnp.float32))(
        m["jparams"], {"tokens": jnp.asarray(m["prompts"])}, jprog)
    tokens, logits = greedy_generate(m["params"], m["cfg"], torch.from_numpy(m["prompts"]), GEN,
                                     policy=tpol, compute_dtype=torch.float32,
                                     programmed=m["progs"][kind], collect_logits=True)
    assert tokens.shape == (2, GEN + 1)
    assert np.array_equal(tokens.numpy(), want), (tokens.tolist(), want.tolist())
    assert np.isfinite(logits.numpy()).all()
    agree(kind, logits[:, 0].numpy(), first)


def _serve(m, kind):
    """The port's ``ServeLoop`` on the workload (one run a policy, kept)."""
    if kind not in m["served"]:
        sc = ServeConfig(policy=policies(kind)[1], compute_dtype=torch.float32, device="cpu",
                         collect_logits=True, **LOOP)
        m["served"][kind] = ServeLoop(m["params"], m["cfg"], sc, programmed=m["progs"][kind]).run(
            [Request(i, p, g) for i, (p, (_, g)) in enumerate(zip(m["requests"], WORKLOAD))])
    return m["served"][kind]


@pytest.mark.parametrize("kind", ["digital", "mem_faithful"])
def test_serveloop_matches_reference_at_same_chunk(model, kind):
    m = model
    jpol, tpol = policies(kind)
    ref = JServeLoop(m["jparams"], m["jcfg"], JServeConfig(
        policy=jpol, compute_dtype=jnp.float32, collect_logits=True, **LOOP),
        programmed=m["jprogs"][kind],
    ).run([JRequest(i, p, g) for i, (p, (_, g)) in enumerate(zip(m["requests"], WORKLOAD))])
    got = _serve(m, kind)
    assert got.prefill_chunks_run == ref.prefill_chunks_run == 4
    for a, b in zip(got.results, ref.results):
        assert a.tokens == b.tokens, (a.rid, a.tokens, b.tokens)
        for x, y in zip(a.logits, b.logits):
            agree(kind, x, y, LOOP_FAITHFUL)


def test_serveloop_batched_equals_solo(model):
    m = model
    reqs = [Request(i, p, g) for i, (p, (_, g)) in enumerate(zip(m["requests"], WORKLOAD))]
    batched = _serve(m, "mem_faithful")
    solo = ServeLoop(m["params"], m["cfg"], ServeConfig(
        policy=policies("mem_faithful")[1], compute_dtype=torch.float32, device="cpu",
        collect_logits=True, **dict(LOOP, slots=1)), programmed=m["progs"]["mem_faithful"])
    for r, res in zip(reqs, batched.results):
        alone = solo.run([r]).results[0]
        assert res.tokens == alone.tokens and len(res.tokens) == r.max_new_tokens
        assert all(np.array_equal(x, y) for x, y in zip(res.logits, alone.logits))


def test_speculative_moe_target_matches_reference():
    m = build(ARCHS[0])
    jpol, tpol = policies("mem_faithful")
    reqs = list(enumerate(zip(m["requests"], WORKLOAD)))
    ref = JServeLoop(m["jparams"], m["jcfg"], JServeConfig(
        policy=jpol, compute_dtype=jnp.float32, spec_k=2, **LOOP),
        programmed=m["jprogs"]["mem_faithful"],
    ).run([JRequest(i, p, g) for i, (p, (_, g)) in reqs])
    got = ServeLoop(m["params"], m["cfg"], ServeConfig(
        policy=tpol, compute_dtype=torch.float32, device="cpu", spec_k=2, **LOOP),
        programmed=m["progs"]["mem_faithful"],
    ).run([Request(i, p, g) for i, (p, (_, g)) in reqs])
    assert got.tokens_drafted > 0 and got.tokens_drafted == ref.tokens_drafted
    for a, b in zip(got.results, ref.results):
        assert a.tokens == b.tokens, (a.rid, a.tokens, b.tokens)


def test_programmed_tree_mirrors_params(model):
    prog = model["progs"]["mem_faithful"]["blocks"]["seg0"]
    cfg = model["cfg"]
    assert sorted(prog) == ["attn", "moe"] and sorted(prog["moe"]) == ["experts", "router"]
    wi = prog["moe"]["experts"]["wi"]
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    assert wi.slices.shape == (cfg.n_layers, e, 4, d, -(-f // 32) * 32)
    assert wi.scale.shape == (cfg.n_layers, e, d // 32, -(-f // 32))
    assert wi.t_prog == 0.0
    fast = model["progs"]["mem_fast"]["blocks"]["seg0"]["moe"]["experts"]["wo"]
    assert fast.w_eff.shape == (cfg.n_layers, e, -(-f // 32) * 32, d)


def test_launcher_matches_reference(capsys):
    args = ["--arch", "qwen3-moe-235b-a22b", "--smoke", "--policy", "mem_faithful",
            "--prompt_len", "8", "--batch", "2", "--gen", "2"]
    want = j_serve.main(args)
    capsys.readouterr()
    got = serve.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert got.shape == (2, 3) and np.array_equal(got.numpy(), np.asarray(want))
    assert "generated (2, 3) tokens in" in out


def test_requests_mode_ranges_expert_rows_alone(capsys):
    """The launcher's ``--requests`` remaps the expert stacks' ``dynamic``
    ADC to ``dynamic_row`` with every other projection: rows of lanes
    that share an expert's buffer stay independent; the router stays
    digital."""
    pol = serve._row_independent(make_policy("mem_faithful"))
    capsys.readouterr()
    assert make_policy("mem_faithful").config_for("L.attn.experts").adc_mode == "dynamic"
    assert pol.config_for("L.attn.experts").adc_mode == "dynamic_row"
    assert pol.config_for("L.attn.router") is None


def test_trainer_refuses_moe(model, capsys):
    """The loss and the train launcher train the smoke config and match
    the reference (the name is from when they refused it)."""
    toks = model["prompts"].repeat(2, axis=1)
    labels = np.roll(toks, -1, 1)
    labels[0, -3:] = -1
    want_l, want_g = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(
        p, model["jcfg"], {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        compute_dtype=jnp.float32, loss_chunk=12)))(model["jparams"])
    p = tree_map(lambda t: t.clone().requires_grad_(True), model["params"])
    loss = loss_fn(p, model["cfg"], {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels)},
                   compute_dtype=torch.float32, loss_chunk=12)
    got_g = torch.autograd.grad(loss, tree_leaves(p))
    assert abs(float(loss) - float(want_l)) <= 1e-5 * abs(float(want_l))
    assert max(rel_max(b, a) for a, b in zip(jax.tree.leaves(want_g), got_g)) <= 1e-4
    args = ["--arch", model["arch"], "--smoke", "--steps", "2", "--batch", "2", "--seq", "16"]
    want = j_train.main(args)
    got = train.main(args + ["--device", "cpu"])
    assert len(got) == 2 and all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got, want))
    assert "final loss:" in capsys.readouterr().out
