"""The port's ``loss_fn`` under a faithful hardware policy against the
reference's (32x32 arrays, ``dynamic`` ADC over 24 rows a call, var
0.02, each side programming its own crossbars from the same keys; remat off,
which ``test_torch_train.py`` holds bitwise to remat on), and one
faithful straight-through matmul on the same inputs.

Classes: the STE matmul's forward bitwise (the faithful engine is the
reference's bit for bit on the same operands) and its backward within
max rel 1e-6; the loss of one qwen2-smoke layer (vocab 256) within rel 1e-3 and its
gradients within rel-Fro 5e-2.  The loss is looser because the two
sides' activations part in their last bits (``rsqrt``, summation
orders) and the faithful engine's quantisers turn such differences into
other int8 codes (ROADMAP §C): each projection alone moves the hidden
states by at most ~2e-3 rel-Fro, all of them together by ~1.4e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import DPEConfig as JDPEConfig
from repro.core.layers import MemPolicy as JMemPolicy
from repro.core.layers import mem_matmul as j_mem_matmul
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy
from repro_torch.core.layers import mem_matmul
from repro_torch.core.prng import PRNGKey
from repro_torch.models import init_params, loss_fn
from repro_torch.models.common import tree_leaves, tree_map

torch.set_num_threads(1)

FAITHFUL = dict(mode="faithful", array_size=(32, 32), adc_mode="dynamic", backend="auto",
                var=0.02)


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def test_faithful_loss_fn_matches_reference():
    cfg = get_smoke("qwen2-0.5b").replace(n_layers=1, vocab=256)
    jcfg = j_get_smoke("qwen2-0.5b").replace(n_layers=1, vocab=256)
    jp, tp = j_init_params(jcfg, jax.random.PRNGKey(0)), init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    labels[0, -3:] = -1
    want_l, want_g = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(
        p, jcfg, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
        policy=JMemPolicy(default=JDPEConfig(**FAITHFUL)), rng=jax.random.PRNGKey(3),
        compute_dtype=jnp.float32, loss_chunk=12, remat=False)))(jp)
    p = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    loss = loss_fn(p, cfg, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)},
                   policy=MemPolicy(default=DPEConfig(**FAITHFUL)), rng=PRNGKey(3),
                   compute_dtype=torch.float32, loss_chunk=12, remat=False)
    got_g = torch.autograd.grad(loss, tree_leaves(p))
    assert abs(float(loss) - float(want_l)) <= 1e-3 * abs(float(want_l))
    worst = max(rel_fro(a, b) for a, b in zip(jax.tree.leaves(want_g), got_g))
    assert worst <= 5e-2, worst


def test_faithful_ste_matmul_matches_reference():
    """One faithful STE matmul on the same inputs: forward bitwise,
    backward (plain products) within max rel 1e-6."""
    cfg = FAITHFUL
    rng = np.random.default_rng(5)
    x = rng.standard_normal((32, 96)).astype(np.float32)
    w = (0.1 * rng.standard_normal((96, 80))).astype(np.float32)
    g = rng.standard_normal((32, 80)).astype(np.float32)
    y, pb = jax.vjp(lambda x, w: j_mem_matmul(x, w, jax.random.PRNGKey(4), JDPEConfig(**cfg)),
                    jnp.asarray(x), jnp.asarray(w))
    gx, gw = pb(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ty = mem_matmul(tx, tw, PRNGKey(4), DPEConfig(**cfg))
    ty.backward(torch.from_numpy(g))
    assert np.array_equal(ty.detach().numpy(), np.asarray(y))
    assert max_rel(gx, tx.grad) <= 1e-6 and max_rel(gw, tw.grad) <= 1e-6
