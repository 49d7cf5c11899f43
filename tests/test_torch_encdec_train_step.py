"""Training whisper's encoder-decoder and phi-3-vision's patch prefix on
the port against the JAX reference: ``loss_fn`` digital, the train step
with its side inputs split into microbatches, the launcher and remat.

whisper-smoke and phi3-vision-smoke, float32, the reference jitted (its
whisper comparisons are a class of their own: the jitted reference folds
the sinusoid table with other bits than the eager table the port keeps,
ROADMAP C), both sides on the port's ``init_params`` draw, which is the
reference's bit for bit, and on the same numpy batches.  Classes:

* ``loss_fn`` digital at 2 x 16 tokens: the loss within rel 1e-5 and
  every gradient leaf within max rel 1e-4 (measured: whisper 0 and
  2.1e-6, phi3 0 and 2.4e-6);
* one SGD step of ``make_train_step`` with 2 microbatches, the frames /
  patch embeddings split with the tokens: the loss within rel 1e-5 of the
  reference's 2 microbatches (measured <= 7e-8) and every parameter
  within max rel 1e-5 (measured <= 9.8e-7);
* ``repro_torch.launch.train.main`` (digital, 3 steps of batch 2, AdamW,
  loss chunks of 64, the step donated; phi3's ``--seq 32`` is its 16
  patches and 16 tokens) against the reference's launcher, which draws
  the side inputs of ``synthetic_batch``: every loss within rel 1e-5
  (measured <= 1.5e-7);
* remat on == off bit for bit under ``mem_fast`` (int8 slices folded,
  var 0): each encoder layer and each decoder layer with its
  cross-attention recomputed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.layers import MemPolicy as JMemPolicy
from repro.launch import train as j_train
from repro.models import loss_fn as j_loss_fn
from repro.optim import sgd as j_sgd
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy
from repro_torch.core.prng import PRNGKey
from repro_torch.launch import train
from repro_torch.models import init_params, loss_fn
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import sgd
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(1)

ARCHS = ["whisper-tiny", "phi-3-vision-4.2b"]


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def batches(cfg, b=2, s=16, seed=0):
    """(reference batch, port batch): tokens, labels (the last 3 of row 0
    masked) and the side input, the same numbers on both sides."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[0, -3:] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    name, rows = (("patch_embeds", cfg.vision_prefix) if cfg.vision_prefix else
                  ("frames", cfg.encoder.n_frames))
    v = (0.02 * rng.standard_normal((b, rows, cfg.d_model))).astype(np.float32)
    jb[name] = jnp.asarray(v).astype(jnp.bfloat16)
    tb[name] = torch.from_numpy(v).to(torch.bfloat16)
    return jb, tb


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg, jcfg = get_smoke(arch), j_get_smoke(arch)
    tp = init_params(cfg, 0, device="cpu")
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, tp=tp,
                jp=tree_map(lambda t: jnp.asarray(t.numpy()), tp))


def test_loss_fn_digital_matches_reference(model):
    jb, tb = batches(model["cfg"])
    want_l, want_g = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(
        p, model["jcfg"], jb, policy=JMemPolicy(default=None), rng=jax.random.PRNGKey(3),
        compute_dtype=jnp.float32, loss_chunk=8)))(model["jp"])
    p = tree_map(lambda t: t.clone().requires_grad_(True), model["tp"])
    loss = loss_fn(p, model["cfg"], tb, rng=PRNGKey(3), compute_dtype=torch.float32,
                   loss_chunk=8)
    got_g = torch.autograd.grad(loss, tree_leaves(p))
    assert abs(float(loss.detach()) - float(want_l)) <= 1e-5 * abs(float(want_l))
    pairs = list(zip(jax.tree.leaves(want_g), got_g))
    assert len(pairs) == len(tree_leaves(model["tp"]))
    worst = max(max_rel(a, b) for a, b in pairs)
    assert worst <= 1e-4, worst


def test_microbatches_match_reference(model):
    jb, tb = batches(model["cfg"], b=4, seed=1)
    jopt, opt = j_sgd(lr=1e-2, momentum=0.0), sgd(lr=1e-2, momentum=0.0)
    jstep = jax.jit(j_make_step(model["jcfg"], jopt, compute_dtype=jnp.float32, loss_chunk=16,
                                microbatches=2))
    step = make_train_step(model["cfg"], opt, compute_dtype=torch.float32, loss_chunk=16,
                           microbatches=2)
    js, jm = jstep(j_init_state(model["jp"], jopt), jb)
    s, m = step(init_train_state(model["tp"], opt), tb)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    worst = max(max_rel(a, b) for a, b in zip(jax.tree.leaves(js["params"]),
                                              tree_leaves(s["params"])))
    assert worst <= 1e-5, worst


@pytest.mark.parametrize("arch,seq", [("whisper-tiny", 16), ("phi-3-vision-4.2b", 32)])
def test_launcher_matches_reference(arch, seq, capsys):
    args = ["--arch", arch, "--smoke", "--steps", "3", "--batch", "2", "--seq", str(seq)]
    want = j_train.main(args)
    got = train.main(args + ["--device", "cpu"])
    assert len(got) == 3 and all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got, want))
    assert "final loss:" in capsys.readouterr().out


def test_remat_on_equals_off_bitwise(model):
    _, tb = batches(model["cfg"], seed=2)
    kw = dict(policy=MemPolicy(default=DPEConfig(mode="fast", var=0.0)), rng=PRNGKey(1),
              compute_dtype=torch.float32, loss_chunk=8)
    out = []
    for remat in (True, False):
        p = tree_map(lambda t: t.clone().requires_grad_(True), model["tp"])
        loss = loss_fn(p, model["cfg"], tb, remat=remat, **kw)
        out.append((loss.detach(), torch.autograd.grad(loss, tree_leaves(p))))
    (l1, g1), (l0, g0) = out
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))
