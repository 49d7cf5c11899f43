"""Training jamba's hybrid groups on the port against the JAX reference:
faithful gradients through the Mamba projections, the launcher's steps
and remat.

Both sides take the port's ``init_params`` draw, which is the
reference's bit for bit; float32, the reference jitted.  Classes:

* ``mem_faithful`` (32x32 arrays, ``dynamic`` ADC, var 0.02) on the
  five Mamba projections (``L.ssm.*``) of a two-layer period of
  jamba-smoke's widths (a Mamba layer, then an attention layer; dense
  MLP), vocab 256, 2 x 8 tokens, one key: the loss within rel 1e-3
  (measured 2.8e-5), every gradient within rel-Fro 5e-2 (measured
  8.2e-3): the faithful trainer's class, the quantisers turn the two sides' last-bit
  differences into other codes.  The whole jamba-smoke period faithful
  takes ~90 s on the reference's side;
* ``repro_torch.launch.train.main(["--arch", "jamba-v0.1-52b",
  "--smoke", ...])`` (digital, 3 steps of batch 2 x 16, AdamW, the
  step of ``make_train_step`` with loss chunks of 64, donated) against
  the reference's launcher: every loss within rel 1e-5 (measured
  <= 2.1e-7);
* remat on == off bit for bit: jamba-smoke (MoE layers included) under
  ``mem_fast`` (int8 slices folded, var 0: the recompute quantises and
  programs every weight again).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import DPEConfig as JDPEConfig
from repro.core.layers import MemPolicy as JMemPolicy
from repro.launch import train as j_train
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy
from repro_torch.core.prng import PRNGKey
from repro_torch.launch import train
from repro_torch.models import init_params, loss_fn
from repro_torch.models.common import tree_leaves, tree_map

torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"
FAITHFUL = dict(mode="faithful", array_size=(32, 32), adc_mode="dynamic", backend="auto",
                var=0.02)
# one Mamba layer and one attention layer of jamba-smoke's widths
PERIOD2 = dict(n_layers=2, hybrid_period=2, hybrid_attn_idx=(1,), hybrid_moe_idx=(), vocab=256)


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


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


def test_faithful_loss_fn_matches_reference():
    cfg, jcfg = get_smoke(ARCH).replace(**PERIOD2), j_get_smoke(ARCH).replace(**PERIOD2)
    tp = init_params(cfg, 0, device="cpu")
    assert [cfg.layer_kind(i)[0] for i in range(2)] == ["ssm", "attn"]
    jp = tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    toks, labels = _batch(cfg.vocab, 8)
    over = (r"L\.ssm\.", JDPEConfig(**FAITHFUL))
    want_l, want_g = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(
        p, jcfg, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        policy=JMemPolicy(overrides=(over,)), rng=jax.random.PRNGKey(3),
        compute_dtype=jnp.float32, loss_chunk=8, remat=False)))(jp)
    got_l, got_g = _port_loss_and_grads(
        tp, cfg, toks, labels, policy=MemPolicy(overrides=((over[0], DPEConfig(**FAITHFUL)),)),
        rng=PRNGKey(3), compute_dtype=torch.float32, loss_chunk=8, remat=False)
    assert abs(float(got_l) - float(want_l)) <= 1e-3 * abs(float(want_l))
    worst = max(rel_fro(a, b) for a, b in zip(jax.tree.leaves(want_g), got_g))
    assert worst <= 5e-2, worst


def test_launcher_matches_reference(capsys):
    args = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2", "--seq", "16"]
    want = j_train.main(args)
    got = train.main(args + ["--device", "cpu"])
    assert len(got) == 3 and all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(got, want))
    assert "final loss:" in capsys.readouterr().out


def test_remat_on_equals_off_bitwise():
    cfg = get_smoke(ARCH)
    tp = init_params(cfg, 0, device="cpu")
    toks, labels = _batch(cfg.vocab, 16, seed=2)
    kw = dict(policy=MemPolicy(default=DPEConfig(mode="fast", var=0.0)), rng=PRNGKey(1),
              compute_dtype=torch.float32, loss_chunk=8)
    l1, g1 = _port_loss_and_grads(tp, cfg, toks, labels, remat=True, **kw)
    l0, g0 = _port_loss_and_grads(tp, cfg, toks, labels, remat=False, **kw)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))
