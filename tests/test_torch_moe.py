"""The port's token-choice top-k MoE (``repro_torch.models.moe``) against
the JAX reference's (``repro.models.moe``), on the same numpy inputs.

qwen3-moe-smoke (8 experts, top 2, d_model 128, d_expert 96) and
kimi-k2-smoke (12 experts, top 3, d_expert 64), float32, the reference
jitted as its model runs it.  Hardware policies: int8 x int8 slices on
32x32 arrays, ``dynamic_row`` ADC, float32 store, backend ``auto``, the
router kept digital (``make_policy``'s override).  Classes:

* ``moe_capacity`` over a grid of S, E, k and capacity factor, and
  ``_dispatch_indices`` (with and without capacity overflow): equal;
* ``init_params`` (two seeds): bitwise, leaf by leaf;
* the programmed expert stacks: bitwise the reference's EAGER
  ``program_weight`` of each expert with its key (its compiled
  programming departs from its eager one, ROADMAP §C);
* ``moe_block`` with inputs whose products are exact (integer-valued
  weights and tokens, ``relu2``): bitwise, for top 1, 2, 3 and 8 (the
  combine's fused multiply-adds are XLA's);
* ``moe_block`` on random inputs: digital max rel <= 1e-5 (the router's
  and the experts' dot orders); ``mem_fast`` rel-Fro <= 1e-5 and
  ``mem_faithful`` <= 1e-3 with one programmed state carried across (the
  last-bit differences of the gate and ``silu`` move whole int8 input
  codes of ``wo``); the same with most choices dropped by capacity;
* ``top_k`` with exact ties: ``jax.lax.top_k``'s experts, and a router
  of zeros through the whole block;
* the stacked plain K1 (``ops.fused_sliced_matmul`` on a stack on the
  CPU, ``dpe_apply``): bitwise a loop of the single plain K1 over the
  experts, ``dynamic`` ranges in 32-row tiles of each expert's rows;
* per-call programming of the stacks equals the programmed run, tokens
  and logits bit for bit (kimi-k2-smoke, ``greedy_generate``);
* ``stack_layers`` of one step: a view of its layer (no second copy);
  ``tree_leaves`` holds no reference to the leaves after it returns.

``tests/test_torch_cuda.py`` holds the stacked K1 on the card against the
single-weight K1 on every expert and against its plain version.
"""
import gc
import weakref

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
from repro.core.layers import layer_key as j_layer_key
from repro.models import init_params as j_init_params
from repro.models import moe as jmoe
from repro.models.config import MoEConfig as JMoEConfig
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec
from repro_torch.core import dpe as tdpe
from repro_torch.core.prng import PRNGKey, fold_in
from repro_torch.kernels import ops
from repro_torch.kernels import sliced_matmul as sm
from repro_torch.models import convert, init_params, moe, program_params
from repro_torch.models.common import layer_slice, stack_layers, tree_leaves
from repro_torch.models.config import MoEConfig
from repro_torch.serve import greedy_generate

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

ARCHS = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"]
KINDS = ["digital", "mem_fast", "mem_faithful"]
TOL = {"digital": 1e-5, "mem_fast": 1e-5, "mem_faithful": 1e-3}


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


def j_block(jcfg, jpol, **kw):
    return jax.jit(lambda p, x, prog: jmoe.moe_block(
        p, x, jcfg, policy=jpol, rng=jax.random.PRNGKey(0), name="L.attn", prepared=prog, **kw))


def t_block(p, x, cfg, tpol, prog=None):
    return moe.moe_block(p, torch.from_numpy(x), cfg, policy=tpol, rng=PRNGKey(0),
                         name="L.attn", prepared=prog).numpy()


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg, jcfg = get_smoke(arch), j_get_smoke(arch)
    params = init_params(cfg, 0, device="cpu")
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, params=params,
                moe=layer_slice(params["blocks"]["seg0"], 0)["moe"])


def test_capacity_matches_reference():
    for s in (1, 2, 7, 15, 16, 32, 33, 100, 1000, 4096):
        for e in (8, 12, 16, 128, 384):
            for k in (1, 2, 3, 8):
                for f in (0.5, 1.0, 1.25, 2.0):
                    got = moe.moe_capacity(MoEConfig(e, k, 64, capacity_factor=f), s)
                    want = jmoe.moe_capacity(JMoEConfig(e, k, 64, capacity_factor=f), s)
                    assert got == want and got % 8 == 0 and got >= 8, (s, e, k, f, got, want)
    assert moe.moe_capacity(get_smoke(ARCHS[0]).moe, 16) == 8  # 16*2/8*1.25 = 5 -> 8
    assert moe.moe_capacity(get_smoke(ARCHS[0]).moe, 32) == 16


@pytest.mark.parametrize("case", ["fits", "overflow"])
def test_dispatch_indices_match_reference(case):
    rng = np.random.default_rng(3)
    t, k, e = 24, 3, 5
    cap = 16 if case == "fits" else 4
    rows = [rng.integers(0, e, (t, k)).astype(np.int32) for _ in range(3)]
    if case == "overflow":  # most choices on expert 1: past its capacity
        rows[0][:, 0] = 1
    batched = moe._dispatch_indices(torch.from_numpy(np.stack(rows)), e, cap)
    for r, eidx in enumerate(rows):
        want = [np.asarray(a) for a in jmoe._dispatch_indices(jnp.asarray(eidx), e, cap)]
        got = moe._dispatch_indices(torch.from_numpy(eidx), e, cap)
        for name, g, b, w in zip(("buf", "slot", "valid", "token"), got, batched, want):
            assert np.array_equal(g.numpy(), w), (case, r, name)
            assert np.array_equal(b[r].numpy(), w), (case, r, name)
        if case == "overflow" and r == 0:
            assert not want[2].all()  # some choices were dropped


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_bitwise(arch, seed):
    cfg, jcfg = get_smoke(arch), j_get_smoke(arch)
    got = tree_leaves(init_params(cfg, seed, device="cpu"), paths=True)
    want = jax.tree_util.tree_leaves_with_path(j_init_params(jcfg, jax.random.PRNGKey(seed)))
    assert len(got) == len(want)
    for (path, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and np.array_equal(a.numpy(), np.asarray(b)), path
    assert any(p.endswith("moe/experts/wi") for p, _ in got)
    # the reference's uniform_init takes fan_in = E for an (E, d, f) stack
    wi = dict(got)["blocks/seg0/moe/experts/wi"]
    assert float(wi.abs().max()) <= (3.0 / cfg.moe.n_experts) ** 0.5


@pytest.mark.parametrize("kind", ["mem_fast", "mem_faithful"])
def test_programmed_stacks_match_reference_eager(model, kind):
    """Each expert of each stack: bitwise the reference's eager
    ``program_weight`` with ``fold_in(layer_key(rng_l, "L.attn.experts"),
    i)``, i in [0, E) for wi, [E, 2E) for wg, [2E, 3E) for wo."""
    jpol, tpol = policies(kind)
    prog = program_params(model["params"], model["cfg"], tpol)
    seg = prog["blocks"]["seg0"]
    assert sorted(seg) == ["attn", "moe"] and seg["moe"]["router"] is None
    e = model["cfg"].moe.n_experts
    for layer in range(model["cfg"].n_layers):
        rng_l = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 0), layer)
        key = j_layer_key(rng_l, "L.attn.experts")
        jcfg = jpol.config_for("L.attn.experts")
        p_l = layer_slice(model["params"]["blocks"]["seg0"], layer)["moe"]["experts"]
        for j, name in enumerate(("wi", "wg", "wo")):
            stack = layer_slice(seg, layer)["moe"]["experts"][name]
            for i in range(0, e, 3):  # every third expert keeps the eager loop short
                want = jdpe.program_weight(jnp.asarray(p_l[name][i].numpy()), jcfg,
                                           jax.random.fold_in(key, j * e + i))
                if kind == "mem_fast":
                    assert np.array_equal(stack.w_eff[i].numpy(), np.asarray(want.w_eff))
                else:
                    assert np.array_equal(stack.slices[i].numpy(), np.asarray(want.slices))
                    assert np.array_equal(stack.scale[i].numpy(), np.asarray(want.scale))


def _exact_inputs(cfg, seed, s=16):
    """Integer-valued tokens and small dyadic weights: every product and
    dot in the block is exact, so only the softmax, top-k and combine
    can part the two sides."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.moe.d_expert, cfg.moe.n_experts
    p = {"router": {"w": (rng.integers(-4, 5, (d, e)) / 64).astype(np.float32)},
         "experts": {"wi": (rng.integers(-2, 3, (e, d, f)) / 4).astype(np.float32),
                     "wg": (rng.integers(-2, 3, (e, d, f)) / 4).astype(np.float32),
                     "wo": (rng.integers(-2, 3, (e, f, d)) / 8).astype(np.float32)}}
    x = rng.integers(-3, 4, (2, s, d)).astype(np.float32)
    return p, x


@pytest.mark.parametrize("top_k", [1, 2, 3, 8])
def test_block_bitwise_on_exact_products(top_k):
    """The combine ``y + vals * wk`` as XLA's CPU code computes it: the
    first two choices as one fused multiply-add over the second's product,
    then one per choice; the softmax's ``exp`` and sum are XLA's."""
    cfg = get_smoke(ARCHS[0]).replace(act="relu2", moe=MoEConfig(16, top_k, 96))
    jcfg = j_get_smoke(ARCHS[0]).replace(act="relu2", moe=JMoEConfig(16, top_k, 96))
    p, x = _exact_inputs(cfg, top_k)
    want = np.asarray(j_block(jcfg, JMemPolicy(default=None))(p, jnp.asarray(x), None))
    tp = convert.params_from_numpy(p, "cpu")
    got = t_block(tp, x, cfg, MemPolicy(default=None))
    assert np.array_equal(got, want), np.abs(got - want).max()


@pytest.mark.parametrize("drop", [False, True], ids=["fits", "drop"])
@pytest.mark.parametrize("kind", KINDS)
def test_block_matches_reference(model, kind, drop):
    cfg, jcfg, p = model["cfg"], model["jcfg"], model["moe"]
    jpol, tpol = policies(kind)
    x = np.random.default_rng(5).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    if drop:  # a router column that wins every token: expert 2 overflows
        p = dict(p, router={"w": p["router"]["w"].clone()})
        p["router"]["w"][:, 2] += 0.5 * torch.from_numpy(np.sign(x[0, 0]))
        x = x + 2.0 * x[:1, :1]
        eidx = moe._top_k(torch.softmax(torch.from_numpy(x) @ p["router"]["w"], -1),
                          cfg.moe.top_k)[1]
        assert int((eidx == 2).sum(dim=(1, 2)).max()) > moe.moe_capacity(cfg.moe, 16)
    prog = None
    if kind != "digital":
        prog = {"router": None, "experts": moe.program_experts(
            p["experts"], tpol.config_for("L.attn.experts"), fold_in(PRNGKey(0), 7))}
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
    want = np.asarray(j_block(jcfg, jpol)(jp, jnp.asarray(x), to_reference(prog)))
    got = t_block(p, x, cfg, tpol, prog)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = rel_max(got, want) if kind == "digital" else rel_fro(got, want)
    assert err <= TOL[kind], (kind, err)


def test_top_k_ties_pick_reference_experts():
    rng = np.random.default_rng(2)
    probs = rng.integers(0, 4, (64, 12)).astype(np.float32) / 4  # many exact ties
    for k in (1, 2, 3, 8, 12):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = moe._top_k(torch.from_numpy(probs), k)
        assert np.array_equal(ti.numpy(), np.asarray(ji)) and np.array_equal(tv.numpy(),
                                                                              np.asarray(jv))


def test_zero_router_ties_through_block(model):
    """A router of zeros: every expert ties, the first top_k experts take
    every token (and overflow), as in the reference."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    p = dict(model["moe"], router={"w": torch.zeros_like(model["moe"]["router"]["w"])})
    x = np.random.default_rng(6).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
    want = np.asarray(j_block(jcfg, JMemPolicy(default=None))(jp, jnp.asarray(x), None))
    got = t_block(p, x, cfg, MemPolicy(default=None))
    assert rel_max(got, want) <= 1e-5
    assert np.abs(got[:, moe.moe_capacity(cfg.moe, 16):]).max() == 0  # dropped tokens


@pytest.mark.parametrize("adc_mode", ["dynamic", "dynamic_row"])
def test_stacked_plain_k1_equals_expert_loop(adc_mode):
    cfg = DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"), array_size=(32, 32),
                    adc_mode=adc_mode, backend="auto")
    rng = np.random.default_rng(8)
    e, m, k, n = 3, 40, 80, 72
    w = torch.from_numpy(rng.standard_normal((e, k, n)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((e, m, k)).astype(np.float32))
    x[1, 5:] = 0.0  # zero padding rows, as an expert's unfilled slots
    x[2] = 0.0  # an expert no token was routed to
    prog = moe.program_experts({"wi": w, "wg": w, "wo": w}, cfg, PRNGKey(4))["wi"]
    kw = dict(input_spec=cfg.input_spec, weight_spec=cfg.weight_spec,
              array_size=cfg.array_size, rdac=cfg.rdac, radc=cfg.radc, adc_mode=adc_mode,
              bm=32)
    stacked = ops.fused_sliced_matmul(x, prog.slices, prog.scale, **kw)
    loop = [sm.fused_sliced_matmul_ref(x[i], prog.slices[i], prog.scale[i], **kw)
            for i in range(e)]
    assert stacked.shape == (e, m, prog.slices.shape[-1])
    assert torch.equal(stacked, torch.stack(loop))
    assert not torch.signbit(stacked[2]).any() and not stacked[2].any()
    ycfg = cfg.replace(backend="xla")  # one range over each expert's 40 rows
    got = tdpe.dpe_apply(x, prog, n, ycfg)
    for i in range(e):
        one = tdpe.PreparedWeight(prog.slices[i], prog.scale[i], prog.t_prog)
        assert torch.equal(got[i], tdpe.dpe_matmul_prepared(x[i], one, n, ycfg))


def test_programmed_equals_per_call():
    """kimi-k2-smoke through ``greedy_generate`` under ``mem_faithful``:
    the stacks programmed once, or on every call from the same keys."""
    cfg = get_smoke(ARCHS[1])
    params = init_params(cfg, 0, device="cpu")
    _, pol = policies("mem_faithful")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, 4)))

    def run(**kw):
        return greedy_generate(params, cfg, prompt, 2, policy=pol, compute_dtype=torch.float32,
                               collect_logits=True, **kw)

    a, la = run(programmed=program_params(params, cfg, pol))
    b, lb = run(weight_stationary=False)
    assert torch.equal(a, b) and torch.equal(la, lb)


def test_tree_leaves_leaves_no_reference_cycle():
    """``tree_leaves`` (``programmed_byte_size`` calls it on 49.75 GB of
    qwen3-moe state) keeps no reference to the leaves once its result is
    dropped, without the garbage collector."""
    leaf = torch.ones(3)
    ref = weakref.ref(leaf)
    tree = {"a": {"b": leaf}, "p": tdpe.PreparedWeight(torch.ones(1), torch.ones(1), None)}
    gc.disable()
    try:
        assert len(tree_leaves(tree)) == 3 and len(tree_leaves(tree, paths=True)) == 3
        del tree, leaf
        assert ref() is None
    finally:
        gc.enable()


def test_single_step_stack_is_a_view():
    layer = {"a": torch.arange(6.0).reshape(2, 3),
             "p": tdpe.PreparedWeight(torch.ones(2, 4, 4), torch.ones(1, 1), 0.5)}
    one = stack_layers(lambda i: layer, 1)
    assert one["a"].shape == (1, 2, 3) and one["p"].slices.shape == (1, 2, 4, 4)
    assert one["a"].data_ptr() == layer["a"].data_ptr()
    assert one["p"].slices.untyped_storage().data_ptr() == layer["p"].slices.untyped_storage(
    ).data_ptr()
    assert one["p"].t_prog == 0.5
    two = stack_layers(lambda i: {"a": layer["a"] + i}, 2)
    assert two["a"].data_ptr() != layer["a"].data_ptr()
    assert torch.equal(two["a"][1], layer["a"] + 1)
