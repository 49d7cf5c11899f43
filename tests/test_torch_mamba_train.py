"""Training Mamba layers and jamba's hybrid groups on the port against the
JAX reference: JAX's gradient rules for ``softplus`` and ``log1p``, the
selective scan's reverse scan, the Mamba block's gradients and
``loss_fn`` on jamba-smoke.

jamba-smoke (one period of 8 layers: attention at in-group index 4,
Mamba elsewhere, MoE over 4 experts top 2 on the odd indices; d_model
128, d_inner 256, d_state 8), float32, the reference jitted; both sides
take the port's ``init_params`` draw, which is the reference's bit for
bit (``tests/test_torch_hybrid_serve.py``).  Classes:

* ``xmath.softplus`` and ``xmath.log1p`` (values and gradients, float32
  subnormals and +-large values included, subnormal gradients entering
  as XLA's CPU code takes them) bitwise to ``jax.vjp`` of the jitted
  primitive;
* the selective scan (:class:`~repro_torch.models.ssm._Scan` under
  ``_selective_scan``) against the reference's scan step (``mamba_block``'s
  ``step``, ``repro/models/ssm.py:316-336``) under ``lax.scan`` with its
  ``unroll``, at 16 tokens in one chunk and at 40 tokens in chunks of 16:
  the readouts, the last state and every gradient within max rel 1e-5
  (measured <= 2.5e-7);
* ``mamba_block`` (digital, the causal conv and the block under
  autograd) against ``jax.vjp`` of the reference's jitted block at 16
  and 72 tokens: the output and every gradient (params and input)
  within max rel 1e-4 (measured <= 7.7e-7);
* ``loss_fn`` on jamba-smoke (MoE layers included) digital at 16 tokens:
  the loss within rel 1e-5 (measured 0, bitwise), every gradient leaf
  within max rel 1e-4 (measured 1.6e-5);
* the same under ``mem_fast`` (int8 slices folded, var 0): the loss
  within rel 1e-4 (measured 2.7e-5), every gradient leaf within max rel
  1e-1 (measured 5.4e-2), and the reference's own gradients, its
  embedding moved by about one ulp (relative noise 2e-7), at least half
  as far from its unmoved gradients (measured 5.4e-2).  The port's
  digital forward is within a few ulps of XLA's fused code, not bitwise
  (the final hidden states within max rel 3.3e-6), and the int8 codes
  turn an ulp into a whole code step: the reference moved by an ulp
  shifts its own loss by up to 3.4e-4 and its gradients by up to
  5.8e-2, so this model holds no tighter class (rwkv6-smoke's fast
  forward is bitwise, hence its 1e-5 / 1e-4).

Faithful training, the launcher and remat are
``tests/test_torch_mamba_train_step.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_smoke as j_get_smoke
from repro.core import DPEConfig as JDPEConfig
from repro.core.layers import MemPolicy as JMemPolicy
from repro.models import loss_fn as j_loss_fn
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, xmath
from repro_torch.core.prng import PRNGKey
from repro_torch.models import init_params, loss_fn
from repro_torch.models import ssm as tssm
from repro_torch.models.common import tree_leaves, tree_map

torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _vjp_pair(jf, tf, x, g):
    """(reference value, gradient), (port value, gradient) of one input."""
    want_y, want_g = jax.jit(lambda x, g: (lambda y, pb: (y, pb(g)[0]))(*jax.vjp(jf, x)))(x, g)
    t = torch.tensor(x, requires_grad=True)
    y = tf(t)
    y.backward(torch.from_numpy(g))
    return (np.asarray(want_y), np.asarray(want_g)), (y.detach().numpy(), t.grad.numpy())


_EDGES = np.array([0.0, -0.0, 1e-40, -1e-40, 1e-45, 88.0, -88.0, 100.0, -100.0, 1e30, -1e30,
                   3e38, -3e38], np.float32)
RULES = {
    # name: (reference, port, the input from a normal draw)
    "softplus": (jax.nn.softplus, xmath.softplus, lambda z: np.concatenate([4 * z, _EDGES])),
    # log1p on (-1, inf): the rational form below sqrt(2) - 1 and the log above
    "log1p": (jnp.log1p, xmath.log1p,
              lambda z: np.concatenate([np.abs(z) * 0.3 - 0.2, [0.0, 1e-40, 1e30, 3e38]])),
}


@pytest.mark.parametrize("name", sorted(RULES))
def test_gradient_rule_matches_jax_vjp(name):
    jf, tf, make = RULES[name]
    rng = np.random.default_rng(sorted(RULES).index(name))
    x = make(rng.standard_normal(100_000)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    g[:50] = 1e-39  # subnormal: XLA's CPU code takes it as zero
    (want_y, want_g), (got_y, got_g) = _vjp_pair(jf, tf, x, g)
    assert np.array_equal(got_y, want_y)
    assert np.array_equal(got_g, want_g), (got_g != want_g).sum()
    assert (want_g[:50] == 0).all()


def _j_scan(xc, dt, bmat, cmat, a, h):
    """The reference's selective scan: ``mamba_block``'s ``step`` under
    ``lax.scan`` with its ``unroll``."""
    def step(h, t):
        xt, dtt, bt, ct = t
        da = jnp.exp(dtt[..., None] * a[None])
        dbx = (dtt * xt)[..., None] * bt[:, None, :]
        h = da * h + dbx
        return h, jnp.einsum("bdn,bn->bd", h, ct)

    xs = tuple(v.swapaxes(0, 1) for v in (xc, dt, bmat, cmat))
    h, ys = lax.scan(step, h, xs, unroll=8 if xc.shape[1] >= 64 else 1)
    return ys.swapaxes(0, 1), h


def _scan_inputs(s, seed):
    rng = np.random.default_rng(seed)
    b, d_in, n = 2, 24, 8
    xc = rng.standard_normal((b, s, d_in)).astype(np.float32)
    dt = rng.uniform(0.001, 0.5, (b, s, d_in)).astype(np.float32)
    bmat, cmat = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (d_in, 1))
    h = rng.standard_normal((b, d_in, n)).astype(np.float32)
    return xc, dt, bmat, cmat, a, h


@pytest.mark.parametrize("s,chunk", [(16, 256), (40, 16)])
def test_selective_scan_gradients_match_reference(monkeypatch, s, chunk):
    monkeypatch.setattr(tssm, "SCAN_CHUNK", chunk)
    args = _scan_inputs(s, s)
    rng = np.random.default_rng(100 + s)
    g_y = rng.standard_normal(args[0].shape).astype(np.float32)
    g_h = rng.standard_normal(args[5].shape).astype(np.float32)

    def j_obj(*a):
        y, h = _j_scan(*a)
        return jnp.sum(y * g_y) + jnp.sum(h * g_h)

    want_y, want_h = jax.jit(_j_scan)(*args)
    want_g = jax.jit(jax.grad(j_obj, argnums=tuple(range(6))))(*args)
    t = [torch.tensor(v, requires_grad=True) for v in args]
    y, h = tssm._selective_scan(*t)
    torch.autograd.backward((y, h), (torch.from_numpy(g_y), torch.from_numpy(g_h)))
    assert max_rel(want_y, y.detach()) <= 1e-5
    assert max_rel(want_h, h.detach()) <= 1e-5
    worst = max(max_rel(w, v.grad) for w, v in zip(want_g, t))
    assert worst <= 1e-5, worst
    # without autograd: the same forward, token by token in place
    with torch.no_grad():
        y0, h0 = tssm._selective_scan(*(torch.from_numpy(v) for v in args))
    assert torch.equal(y0, y.detach()) and torch.equal(h0, h.detach())


@pytest.mark.parametrize("s", [16, 72])
def test_mamba_block_gradients_match_reference(s):
    cfg, jcfg = get_smoke(ARCH), j_get_smoke(ARCH)
    p = tssm.init_mamba_params(PRNGKey(3), cfg, device="cpu")
    jp = tree_map(lambda t: jnp.asarray(t.numpy()), p)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)

    def j_block(p, x):
        return jssm.mamba_block(p, x, jcfg, policy=JMemPolicy(default=None),
                                rng=jax.random.PRNGKey(0),
                                name="L.ssm")[0]

    want_y, pb = jax.vjp(jax.jit(j_block), jp, jnp.asarray(x))
    want_gp, want_gx = jax.jit(pb)(jnp.asarray(gy))
    tp = tree_map(lambda t: t.clone().requires_grad_(True), p)
    tx = torch.tensor(x, requires_grad=True)
    y = tssm.mamba_block(tp, tx, cfg, policy=MemPolicy(default=None), rng=PRNGKey(0),
                         name="L.ssm")[0]
    y.backward(torch.from_numpy(gy))
    assert max_rel(want_y, y.detach()) <= 1e-4
    assert max_rel(want_gx, tx.grad) <= 1e-4
    pairs = list(zip(jax.tree.leaves(want_gp), (t.grad for t in tree_leaves(tp))))
    assert len(pairs) == 10
    worst = max(max_rel(a, b) for a, b in pairs)
    assert worst <= 1e-4, worst


@pytest.fixture(scope="module")
def jamba():
    cfg, jcfg = get_smoke(ARCH), j_get_smoke(ARCH)
    tp = init_params(cfg, 0, device="cpu")
    return jcfg, cfg, tree_map(lambda t: jnp.asarray(t.numpy()), tp), tp


def _batch(vocab, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (2, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[0, -3:] = -1
    return toks, labels


# kind: (engine, loss rel bound, gradient leaf max rel bound)
CLASSES = {"digital": (None, 1e-5, 1e-4), "mem_fast": (dict(mode="fast", var=0.0), 1e-4, 1e-1)}


def _j_value_and_grad(jcfg, jpol, toks, labels):
    return jax.jit(jax.value_and_grad(lambda p: j_loss_fn(
        p, jcfg, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}, policy=jpol,
        rng=jax.random.PRNGKey(3), compute_dtype=jnp.float32, loss_chunk=16, remat=False)))


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_loss_fn_matches_reference(jamba, kind):
    jcfg, cfg, jp, tp = jamba
    eng, loss_tol, grad_tol = CLASSES[kind]
    jpol = JMemPolicy(default=None if eng is None else JDPEConfig(**eng))
    tpol = MemPolicy(default=None if eng is None else DPEConfig(**eng))
    toks, labels = _batch(cfg.vocab, 16)
    ref = _j_value_and_grad(jcfg, jpol, toks, labels)
    want_l, want_g = ref(jp)
    p = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss = loss_fn(p, cfg, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)},
                   policy=tpol, rng=PRNGKey(3), compute_dtype=torch.float32, loss_chunk=16,
                   remat=False)
    got_g = torch.autograd.grad(loss, tree_leaves(p))
    assert abs(float(loss.detach()) - float(want_l)) <= loss_tol * abs(float(want_l))
    pairs = list(zip(jax.tree.leaves(want_g), got_g))
    assert len(pairs) == len(tree_leaves(tp))
    assert any(p.endswith("ssm/a_log") for p, _ in tree_leaves(tp, paths=True))
    worst = max(max_rel(a, b) for a, b in pairs)
    assert worst <= grad_tol, worst
    if eng is not None:
        # the reference against itself, its embedding moved by ~1 ulp: the int8 codes
        # of mem_fast turn that into a gradient change at least half the port's
        e = np.asarray(jp["embed"]["w"])
        noise = np.random.default_rng(0).standard_normal(e.shape)
        moved = dict(jp, embed={"w": jnp.asarray((e * (1 + 2e-7 * noise)).astype(np.float32))})
        self_g = jax.tree.leaves(ref(moved)[1])
        assert max(max_rel(a, b) for a, b in zip(jax.tree.leaves(want_g), self_g)) >= worst / 2
