"""Training whisper's encoder-decoder and phi-3-vision's patch prefix on
the port against the JAX reference: ``gelu``'s and ``integer_pow``'s
gradient rules, the prefix's masked labels and the programming keys of
the per-call path.

whisper-smoke (2 encoder layers over 64 frames, 2 decoder layers, d_model
64, gelu, layer norm) and phi3-vision-smoke (2 layers, d_model 128, a
16-patch prefix), batch 2 x 16 tokens, the frames / patch embeddings a
numpy draw cast to bfloat16, float32 compute, the reference jitted
(whisper's jitted comparisons are a class of their own: the reference's
jitted step folds the sinusoid table into its program with other bits
than the eager table the port keeps, 52 % of its elements differ,
ROADMAP C); both sides take the port's ``init_params`` draw, which is
the reference's bit for bit (``tests/test_torch_encdec.py``, ``tests/test_torch_vision.py``).
Classes:

* ``gelu`` (``jax.nn.gelu``, tanh form) and ``xmath.integer_pow`` (the
  cube): values and gradients bitwise to ``jax.vjp`` of the jitted
  function on normal float32 inputs (subnormal gradients included);
  XLA folds the two constants of the cube's gradient into one, which
  the port's rule replays;
* the patch prefix's labels: ``loss_fn`` equals the cross entropy over
  the text positions of ``forward``'s hidden states, bit for bit (the
  prefix's positions take the label -1);
* the per-call path's programming keys (``programmed=None``: every
  projection programmed in the call from ``fold_in(rng, 1000 + i)`` for
  encoder layer ``i``'s attention, ``2000 + i`` for its MLP, ``i`` for
  decoder layer ``i`` and its cross-attention, the layer key chain of a
  decoder-only model for phi3): ``mem_fast`` with var 0.05 (every
  weight's noise drawn from its key) and float32 input slices (no
  input code turns on a last-bit difference): the loss within rel 1e-5
  (measured 7.2e-8 whisper, 0 phi3) and every gradient within max rel
  1e-3 (measured 2.2e-6 whisper, 2.1e-4 phi3).  A wrong key moves a weight
  by its 5 % noise.

Faithful training is ``tests/test_torch_encdec_train_faithful.py``'s;
``loss_fn`` digital, the launcher, ``make_train_step`` with microbatches
and remat are ``tests/test_torch_encdec_train_step.py``'s.
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
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec, xmath
from repro_torch.core.prng import PRNGKey
from repro_torch.models import forward, init_params, loss_fn
from repro_torch.models.common import gelu, tree_leaves, tree_map

torch.set_num_threads(1)

ARCHS = ["whisper-tiny", "phi-3-vision-4.2b"]


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


RULES = {
    "gelu": (jax.nn.gelu, gelu),
    "integer_pow": (lambda v: v ** 3, lambda v: xmath.integer_pow(v, 3)),
}


@pytest.mark.parametrize("name", sorted(RULES))
def test_gradient_rule_matches_jax_vjp(name):
    jf, tf = RULES[name]
    rng = np.random.default_rng(sorted(RULES).index(name))
    x = np.concatenate([3 * rng.standard_normal(200_000), [0.0, -0.0, 20.0, -20.0, 1e5, -1e5]])
    x = x.astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    g[:20] = 1e-39
    want_y, want_g = jax.jit(lambda x, g: (lambda y, pb: (y, pb(g)[0]))(*jax.vjp(jf, x)))(x, g)
    t = torch.tensor(x, requires_grad=True)
    y = tf(t)
    y.backward(torch.from_numpy(g))
    assert np.array_equal(y.detach().numpy(), np.asarray(want_y))
    assert np.array_equal(t.grad.numpy(), np.asarray(want_g)), (t.grad.numpy() != want_g).sum()


def batches(cfg, s=16, seed=0):
    """(reference batch, port batch): tokens, labels (the last 3 of row 0
    masked) and the side input, the same numbers on both sides."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[0, -3:] = -1
    side = {}
    if cfg.vision_prefix:
        side["patch_embeds"] = (2, cfg.vision_prefix, cfg.d_model)
    if cfg.encoder is not None:
        side["frames"] = (2, cfg.encoder.n_frames, cfg.d_model)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    for k, shape in side.items():
        v = (0.02 * rng.standard_normal(shape)).astype(np.float32)
        jb[k] = jnp.asarray(v).astype(jnp.bfloat16)
        tb[k] = torch.from_numpy(v).to(torch.bfloat16)
    return jb, tb


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg, jcfg = get_smoke(arch), j_get_smoke(arch)
    tp = init_params(cfg, 0, device="cpu")
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, tp=tp,
                jp=tree_map(lambda t: jnp.asarray(t.numpy()), tp))


def _both(m, jpol, tpol, **kw):
    """(reference loss, gradients), (port loss, gradients)."""
    jb, tb = batches(m["cfg"])
    want = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(
        p, m["jcfg"], jb, policy=jpol, rng=jax.random.PRNGKey(3), compute_dtype=jnp.float32,
        **kw)))(m["jp"])
    p = tree_map(lambda t: t.clone().requires_grad_(True), m["tp"])
    loss = loss_fn(p, m["cfg"], tb, policy=tpol, rng=PRNGKey(3), compute_dtype=torch.float32,
                   **kw)
    return want, (loss.detach(), torch.autograd.grad(loss, tree_leaves(p)))


def test_per_call_keys_match_reference(model):
    eng = dict(mode="fast", var=0.05)
    (want_l, want_g), (got_l, got_g) = _both(
        model, JMemPolicy(default=JDPEConfig(input_spec=jspec("fp32"), **eng)),
        MemPolicy(default=DPEConfig(input_spec=spec("fp32"), **eng)), loss_chunk=16,
        remat=False)
    assert abs(float(got_l) - float(want_l)) <= 1e-5 * abs(float(want_l))
    worst = max(max_rel(a, b) for a, b in zip(jax.tree.leaves(want_g), got_g))
    assert worst <= 1e-3, worst


def test_prefix_labels_are_masked():
    cfg = get_smoke("phi-3-vision-4.2b")
    params = init_params(cfg, 0, device="cpu")
    _, tb = batches(cfg)
    kw = dict(rng=PRNGKey(3), compute_dtype=torch.float32)
    loss = loss_fn(params, cfg, tb, loss_chunk=64, **kw)
    h = forward(params, cfg, tb, **kw)
    assert h.shape[1] == cfg.vision_prefix + tb["tokens"].shape[1]
    logits = (h[:, cfg.vision_prefix:] @ params["lm_head"]["w"]).to(torch.float32)
    labels = tb["labels"].long()
    mask = (labels >= 0).to(torch.float32)
    picked = torch.gather(logits, -1, labels.clamp_min(0)[..., None])[..., 0]
    want = torch.sum((xmath.logsumexp(logits) - picked) * mask) / torch.sum(mask)
    assert torch.equal(loss, want)
