"""Training the MoE family on the port against the JAX reference: the
router's softmax rule, the straight-through product over an expert
stack, ``loss_fn`` on qwen3-moe-smoke, remat and the launcher's resume.

qwen3-moe-smoke (2 layers, 8 experts top 2, d_expert 96), float32, the
reference jitted, the capacity taken at the same S on both sides; both
sides take the port's ``init_params`` draw, which is the reference's bit
for bit (``tests/test_torch_moe.py``).  Classes:

* ``xmath.softmax``'s gradient bitwise to ``jax.vjp`` of the jitted
  ``jax.nn.softmax`` over qwen3-moe's 128 experts and the smoke's 8 (XLA
  fuses a narrow row's products into its sum);
* ``mem_matmul_stack`` (faithful, 2 experts at key offset 8) against the
  reference's ``vmap``ped ``mem_matmul`` at the keys ``fold_in(key, 8 +
  i)``: forward bitwise, backward within max rel 1e-6 (as
  ``test_faithful_ste_matmul_matches_reference``);
* ``loss_fn`` digital at 96 tokens (capacity 24) and ``mem_fast`` (var
  0) at 16: the loss within rel 1e-5 (measured 7e-8 and bitwise), every
  gradient within max rel 1e-4 (measured 1.8e-6 and 9.1e-7); the digital
  loss at 16 tokens and the launcher are
  ``test_torch_moe_serve.py::test_trainer_refuses_moe`` (named before
  training was ported);
* ``mem_faithful`` expert stacks (32x32 arrays, ``dynamic`` ADC, var
  0.02; the rest digital: faithful attention and heads are
  ``test_torch_train_faithful.py``'s) at 1 layer, vocab 256: the loss
  within rel 1e-3 (measured 1.6e-7), every gradient within rel-Fro 5e-2
  (measured 1.1e-4), PR 18's class (with every projection faithful the
  loss measured 1.7e-4, the gradients 2.0e-3);
* remat on == off bit for bit under ``mem_fast`` (var 0) at 1 layer (each
  stack programmed again in the recompute);
* the launcher's ``--ckpt`` resume equals the uninterrupted run, every
  leaf (the router and the expert stacks included) bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import DPEConfig as JDPEConfig
from repro.core.layers import MemPolicy as JMemPolicy
from repro.core.layers import mem_matmul as j_mem_matmul
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, xmath
from repro_torch.core.layers import mem_matmul_stack
from repro_torch.core.prng import PRNGKey
from repro_torch.launch import train
from repro_torch.models import init_params, loss_fn
from repro_torch.models.common import tree_leaves, tree_map

torch.set_num_threads(1)

ARCH = "qwen3-moe-235b-a22b"
FAITHFUL = dict(mode="faithful", array_size=(32, 32), adc_mode="dynamic", backend="auto",
                var=0.02)


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


@pytest.mark.parametrize("n", [128, 8])
def test_softmax_rule_matches_jax_vjp(n):
    rng = np.random.default_rng(n)
    x = (2 * rng.standard_normal((2, 128, n))).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    f = lambda a: jax.nn.softmax(a, axis=-1)  # noqa: E731
    want_y, want_g = jax.jit(lambda x, g: (lambda y, pb: (y, pb(g)[0]))(*jax.vjp(f, x)))(x, g)
    t = torch.tensor(x, requires_grad=True)
    y = xmath.softmax(t)
    y.backward(torch.from_numpy(g))
    assert np.array_equal(y.detach().numpy(), np.asarray(want_y))
    assert np.array_equal(t.grad.numpy(), np.asarray(want_g))


def test_stack_ste_matches_reference_vmap():
    rng = np.random.default_rng(5)
    e, base = 2, 8
    x = rng.standard_normal((e, 16, 96)).astype(np.float32)
    w = (0.1 * rng.standard_normal((e, 96, 80))).astype(np.float32)
    g = rng.standard_normal((e, 16, 80)).astype(np.float32)
    jcfg = JDPEConfig(**FAITHFUL)
    key = jax.random.PRNGKey(4)

    def j_stack(x, w):
        return jax.vmap(lambda x2, w2, i: j_mem_matmul(x2, w2, jax.random.fold_in(key, i), jcfg))(
            x, w, jnp.arange(e) + base)

    y, pb = jax.vjp(j_stack, jnp.asarray(x), jnp.asarray(w))  # eager: ROADMAP C
    gx, gw = pb(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ty = mem_matmul_stack(tx, tw, PRNGKey(4), DPEConfig(**FAITHFUL), base)
    ty.backward(torch.from_numpy(g))
    assert np.array_equal(ty.detach().numpy(), np.asarray(y))
    assert max_rel(gx, tx.grad) <= 1e-6 and max_rel(gw, tw.grad) <= 1e-6


def _params(cfg):
    """The port's ``init_params`` draw and the same leaves as the
    reference's tree."""
    tp = init_params(cfg, 0, device="cpu")
    return tree_map(lambda t: jnp.asarray(t.numpy()), tp), tp


@pytest.fixture(scope="module")
def moe():
    cfg, jcfg = get_smoke(ARCH), j_get_smoke(ARCH)
    return (jcfg, cfg) + _params(cfg)


def _batch(vocab, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (2, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[0, -3:] = -1
    return toks, labels


def _port_loss_and_grads(params, cfg, toks, labels, **kw):
    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss = loss_fn(p, cfg, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)},
                   **kw)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(p))


def _ref_loss_and_grads(params, cfg, toks, labels, policy, **kw):
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    return jax.jit(jax.value_and_grad(lambda p: j_loss_fn(
        p, cfg, batch, policy=policy, rng=jax.random.PRNGKey(3), compute_dtype=jnp.float32,
        **kw)))(params)


@pytest.mark.parametrize("kind,s", [("digital", 96), ("mem_fast", 16)])
def test_loss_fn_matches_reference(moe, kind, s):
    jcfg, cfg, jp, tp = moe
    pol = dict(mode="fast", var=0.0)
    jpol = JMemPolicy(default=JDPEConfig(**pol) if kind == "mem_fast" else None)
    tpol = MemPolicy(default=DPEConfig(**pol) if kind == "mem_fast" else None)
    toks, labels = _batch(cfg.vocab, s)
    want_l, want_g = _ref_loss_and_grads(jp, jcfg, toks, labels, jpol, loss_chunk=40)
    got_l, got_g = _port_loss_and_grads(tp, cfg, toks, labels, policy=tpol, rng=PRNGKey(3),
                                        compute_dtype=torch.float32, loss_chunk=40)
    assert abs(float(got_l) - float(want_l)) <= 1e-5 * abs(float(want_l))
    pairs = list(zip(jax.tree.leaves(want_g), got_g))
    assert len(pairs) == len(tree_leaves(tp))
    worst = max(max_rel(a, b) for a, b in pairs)
    assert worst <= 1e-4, worst


def test_faithful_loss_fn_matches_reference():
    cfg = get_smoke(ARCH).replace(n_layers=1, vocab=256)
    jcfg = j_get_smoke(ARCH).replace(n_layers=1, vocab=256)
    jp, tp = _params(cfg)
    toks, labels = _batch(cfg.vocab, 12)
    want_l, want_g = _ref_loss_and_grads(
        jp, jcfg, toks, labels, JMemPolicy(overrides=(("experts", JDPEConfig(**FAITHFUL)),)),
        loss_chunk=12, remat=False)
    got_l, got_g = _port_loss_and_grads(
        tp, cfg, toks, labels, policy=MemPolicy(overrides=(("experts", DPEConfig(**FAITHFUL)),)),
        rng=PRNGKey(3), compute_dtype=torch.float32, loss_chunk=12, remat=False)
    assert abs(float(got_l) - float(want_l)) <= 1e-3 * abs(float(want_l))
    worst = max(rel_fro(a, b) for a, b in zip(jax.tree.leaves(want_g), got_g))
    assert worst <= 5e-2, worst


def test_remat_on_equals_off_bitwise():
    cfg = get_smoke(ARCH).replace(n_layers=1)
    tp = init_params(cfg, 0, device="cpu")
    toks, labels = _batch(cfg.vocab, 16, seed=2)
    kw = dict(policy=MemPolicy(default=DPEConfig(mode="fast", var=0.0)), rng=PRNGKey(1),
              compute_dtype=torch.float32, loss_chunk=8)
    l1, g1 = _port_loss_and_grads(tp, cfg, toks, labels, remat=True, **kw)
    l0, g0 = _port_loss_and_grads(tp, cfg, toks, labels, remat=False, **kw)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


def test_resume_equals_uninterrupted_run(tmp_path):
    args = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16", "--device", "cpu"]
    whole, s_whole = train.main(args + ["--steps", "3"], return_state=True)
    first = train.main(args + ["--steps", "2", "--ckpt", str(tmp_path)])
    rest, s_rest = train.main(args + ["--steps", "3", "--ckpt", str(tmp_path)],
                              return_state=True)
    assert first + rest == whole
    paths = [p for p, _ in tree_leaves(s_whole, paths=True)]
    assert any(p.endswith("moe/experts/wi") for p in paths)
    assert any(p.endswith("moe/router/w") for p in paths)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s_whole), tree_leaves(s_rest)))
