"""Faithful training of whisper's encoder-decoder and phi-3-vision's
patch prefix on the port against the JAX reference.

``mem_faithful`` (32x32 arrays, ``dynamic`` ADC, var 0.02) on every
projection, each programmed in the call from the reference's keys
(``programmed=None``), remat off, one key, vocab 256, batch 2 x 8
tokens, float32, the reference jitted: whisper-smoke cut to one encoder
layer over 16 frames and one decoder layer, phi3-vision-smoke cut to
one layer (its 16-patch prefix kept).  Both sides take the port's
``init_params`` draw, which is the reference's bit for bit.  The loss
within rel 1e-3 (measured 8.2e-5 whisper, 5.8e-4 phi3), every gradient
within rel-Fro 5e-2 (measured 2.0e-3 whisper, 1.5e-2 phi3): the faithful
trainer's class, the quantisers turn the two sides' last-bit differences into
other codes.  The smoke configs' whole depth takes ~20 s a model on the
reference's side.
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
from repro.models.config import EncoderConfig as JEncoderConfig
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy
from repro_torch.core.prng import PRNGKey
from repro_torch.models import init_params, loss_fn
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.models.config import EncoderConfig

torch.set_num_threads(1)

FAITHFUL = dict(mode="faithful", array_size=(32, 32), adc_mode="dynamic", backend="auto",
                var=0.02)
ENC = dict(n_layers=1, n_frames=16)
CUTS = {"whisper-tiny": (dict(n_layers=1, vocab=256, encoder=EncoderConfig(**ENC)),
                         dict(n_layers=1, vocab=256, encoder=JEncoderConfig(**ENC))),
        "phi-3-vision-4.2b": (dict(n_layers=1, vocab=256), dict(n_layers=1, vocab=256))}


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


@pytest.mark.parametrize("arch", sorted(CUTS))
def test_faithful_loss_fn_matches_reference(arch):
    cut, jcut = CUTS[arch]
    cfg, jcfg = get_smoke(arch).replace(**cut), j_get_smoke(arch).replace(**jcut)
    tp = init_params(cfg, 0, device="cpu")
    jp = tree_map(lambda t: jnp.asarray(t.numpy()), tp)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[0, -3:] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    side = ("patch_embeds", cfg.vision_prefix) if cfg.vision_prefix else \
        ("frames", cfg.encoder.n_frames)
    v = (0.02 * rng.standard_normal((2, side[1], cfg.d_model))).astype(np.float32)
    jb[side[0]] = jnp.asarray(v).astype(jnp.bfloat16)
    tb[side[0]] = torch.from_numpy(v).to(torch.bfloat16)
    kw = dict(compute_dtype=jnp.float32, loss_chunk=8, remat=False)
    want_l, want_g = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(
        p, jcfg, jb, policy=JMemPolicy(default=JDPEConfig(**FAITHFUL)),
        rng=jax.random.PRNGKey(3), **kw)))(jp)
    p = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    kw["compute_dtype"] = torch.float32
    loss = loss_fn(p, cfg, tb, policy=MemPolicy(default=DPEConfig(**FAITHFUL)), rng=PRNGKey(3),
                   **kw)
    got_g = torch.autograd.grad(loss, tree_leaves(p))
    assert abs(float(loss.detach()) - float(want_l)) <= 1e-3 * abs(float(want_l))
    worst = max(rel_fro(a, b) for a, b in zip(jax.tree.leaves(want_g), got_g))
    assert worst <= 5e-2, worst
