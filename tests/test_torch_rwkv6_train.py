"""Training rwkv6 on the port against the JAX reference: JAX's gradient
rules for the replays the RWKV6 time-mix meets, both WKV forms under
autograd, ``loss_fn`` on rwkv6-smoke, remat and the launcher's resume.

rwkv6-smoke (2 layers, d_model 128, 4 heads of 32), float32, the
reference jitted; both sides take the port's ``init_params`` draw, which
is the reference's bit for bit (``tests/test_torch_rwkv6.py``; copying
it skips the reference's eager draw, ~6 s).  Classes:

* the gradient rules of ``xmath`` (``tanh`` at the decay LoRA's 64
  columns, ``cumsum_last`` over 32-wide rows as the chunked form's
  cumulative sum, ``ftz`` as ``ssm._exp``'s flush, ``logistic`` and
  ``silu`` at ``g_proj``'s 2,048 columns) bitwise to ``jax.vjp`` of the
  jitted primitive;
* ``_wkv_scan`` (16 tokens) and ``_wkv_chunked`` (72 tokens: 3 chunks,
  the last padded; decays down to 0, masked ``-inf`` exponents, the
  ``1e-37`` clamp): outputs and every gradient within max rel 1e-5
  (measured <= 1.5e-6);
* ``loss_fn`` digital at 96 tokens (the chunked form, its last chunk
  padded) and ``mem_fast`` (int8 slices folded, var 0) at 16: the loss
  within rel 1e-5 (measured bitwise digital, 7e-8 fast), every gradient
  within max rel 1e-4 (measured 1.4e-5 digital, 3.5e-6 fast); the
  digital loss at 16 tokens and the launcher are
  ``test_torch_ssm_serve.py::test_trainer_refuses_rwkv6`` (named before
  training was ported);
* ``mem_faithful`` (32x32 arrays, ``dynamic`` ADC, var 0.02) at 1 layer,
  vocab 256: the loss within rel 1e-3 (measured 8.3e-5), every gradient
  within rel-Fro 5e-2 (measured 1.2e-3): PR 18's class, the quantisers
  turn the two sides' last-bit differences into other codes;
* remat on == off bit for bit (digital, the chunked form: each group of
  chunks checkpointed inside each layer's checkpoint);
* the launcher's ``--ckpt`` resume equals the uninterrupted run, every
  leaf (``mu``, ``u``, ``w_lora_*`` included) bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import DPEConfig as JDPEConfig
from repro.core.layers import MemPolicy as JMemPolicy
from repro.models import loss_fn as j_loss_fn
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, xmath
from repro_torch.core.prng import PRNGKey
from repro_torch.launch import train
from repro_torch.models import init_params, loss_fn
from repro_torch.models import ssm as tssm
from repro_torch.models.common import tree_leaves, tree_map

torch.set_num_threads(1)

ARCH = "rwkv6-1.6b"
FAITHFUL = dict(mode="faithful", array_size=(32, 32), adc_mode="dynamic", backend="auto",
                var=0.02)


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _vjp_pair(jf, tf, x, g):
    """(reference value, gradient), (port value, gradient) of one input."""
    want_y, want_g = jax.jit(lambda x, g: (lambda y, pb: (y, pb(g)[0]))(*jax.vjp(jf, x)))(x, g)
    t = torch.tensor(x, requires_grad=True)
    y = tf(t)
    y.backward(torch.from_numpy(g))
    return (np.asarray(want_y), np.asarray(want_g)), (y.detach().numpy(), t.grad.numpy())


RULES = {
    # name: (reference, port, input shape, input scale, input shift)
    "tanh": (jnp.tanh, xmath.tanh, (4, 128, 64), 1.0, 0.0),
    "cumsum": (lambda a: jnp.cumsum(a, axis=-1), xmath.cumsum_last, (4, 4, 32, 64, 32), 1.0,
               0.0),
    # XLA flushes exp's subnormal results; their gradient g * 0 is 0
    "ftz": (jnp.exp, tssm._exp, (64, 1024), 8.0, -92.0),
    "logistic": (jax.nn.sigmoid, xmath.logistic, (4, 128, 2048), 3.0, 0.0),
    "silu": (jax.nn.silu, tssm._silu, (4, 128, 2048), 3.0, 0.0),
}


@pytest.mark.parametrize("name", sorted(RULES))
def test_gradient_rule_matches_jax_vjp(name):
    jf, tf, shape, scale, shift = RULES[name]
    rng = np.random.default_rng(sorted(RULES).index(name))
    x = (scale * rng.standard_normal(shape) + shift).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    (want_y, want_g), (got_y, got_g) = _vjp_pair(jf, tf, x, g)
    assert np.array_equal(got_y, want_y)
    assert np.array_equal(got_g, want_g), (got_g != want_g).mean()
    if name == "ftz":
        assert (want_y == 0).any() and (want_g == 0).any()


def _wkv_inputs(s, seed):
    """r / k / v / w (B, S, H, N), u (H, N), state (B, H, N, N): decays in
    (0, 1), a tenth of them 0 (clamped to 1e-37 before the log)."""
    rng = np.random.default_rng(seed)
    b, h, n = 2, 2, 8
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.05, 1.0, (b, s, h, n)).astype(np.float32)
    w[rng.random(w.shape) < 0.1] = 0.0
    u = rng.standard_normal((h, n)).astype(np.float32)
    st = rng.standard_normal((b, h, n, n)).astype(np.float32)
    return r, k, v, w, u, st


@pytest.mark.parametrize("form,s", [("scan", 16), ("chunked", 72)])
def test_wkv_forms_gradients_match_reference(form, s):
    args = _wkv_inputs(s, s)
    jf = getattr(jssm, f"_wkv_{form}")
    tf = getattr(tssm, f"_wkv_{form}")
    rng = np.random.default_rng(100 + s)
    g_out = rng.standard_normal(args[0].shape).astype(np.float32)
    g_st = rng.standard_normal(args[5].shape).astype(np.float32)

    def j_obj(*a):
        out, st = jf(*a)
        return jnp.sum(out * g_out) + jnp.sum(st * g_st)

    (want_out, want_st) = jax.jit(jf)(*args)
    want_g = jax.jit(jax.grad(j_obj, argnums=tuple(range(6))))(*args)
    t = [torch.tensor(a, requires_grad=True) for a in args]
    out, st = tf(*t)
    torch.autograd.backward((out, st), (torch.from_numpy(g_out), torch.from_numpy(g_st)))
    assert max_rel(want_out, out.detach()) <= 1e-5
    assert max_rel(want_st, st.detach()) <= 1e-5
    worst = max(max_rel(a, b.grad) for a, b in zip(want_g, t))
    assert worst <= 1e-5, worst


def _params(cfg):
    """The port's ``init_params`` draw and the same leaves as the
    reference's tree."""
    tp = init_params(cfg, 0, device="cpu")
    return tree_map(lambda t: jnp.asarray(t.numpy()), tp), tp


@pytest.fixture(scope="module")
def rwkv():
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
def test_loss_fn_matches_reference(rwkv, kind, s):
    jcfg, cfg, jp, tp = rwkv
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
    want_l, want_g = _ref_loss_and_grads(jp, jcfg, toks, labels,
                                         JMemPolicy(default=JDPEConfig(**FAITHFUL)),
                                         loss_chunk=12, remat=False)
    got_l, got_g = _port_loss_and_grads(tp, cfg, toks, labels,
                                        policy=MemPolicy(default=DPEConfig(**FAITHFUL)),
                                        rng=PRNGKey(3), compute_dtype=torch.float32,
                                        loss_chunk=12, remat=False)
    assert abs(float(got_l) - float(want_l)) <= 1e-3 * abs(float(want_l))
    worst = max(rel_fro(a, b) for a, b in zip(jax.tree.leaves(want_g), got_g))
    assert worst <= 5e-2, worst


def test_remat_on_equals_off_bitwise(rwkv):
    _, cfg, _, tp = rwkv
    toks, labels = _batch(cfg.vocab, 96, seed=2)
    kw = dict(policy=MemPolicy(default=None), rng=PRNGKey(1), compute_dtype=torch.float32,
              loss_chunk=32)
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
    assert any(p.endswith("ssm/mu") for p in paths) and any("w_lora" in p for p in paths)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s_whole), tree_leaves(s_rest)))
