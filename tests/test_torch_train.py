"""The port's loss, remat, ``GradCompression`` and ``synthetic_batch``
against the JAX reference (the faithful loss is
``test_torch_train_faithful.py``, the train step
``test_torch_train_step.py``).

qwen2-smoke with the reference's weights (``init_params`` draws them bit
for bit), float32.  Classes:

* ``loss_fn`` digital and ``mem_fast`` (var 0.02): the loss bitwise,
  every gradient within max rel 1e-5;
* remat on equals remat off, bit for bit (digital and ``mem_fast``);
* ``GradCompression``: bitwise to the reference's jitted step;
* ``synthetic_batch``: bitwise within one process.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import DPEConfig as JDPEConfig
from repro.core.layers import MemPolicy as JMemPolicy
from repro.data.pipeline import synthetic_batch as j_synthetic_batch
from repro.distributed.compression import GradCompression as JGradCompression
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy
from repro_torch.core.prng import PRNGKey
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.distributed.compression import GradCompression, _quant_dequant
from repro_torch.models import init_params, loss_fn
from repro_torch.models.common import tree_leaves, tree_map

torch.set_num_threads(1)

def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _batch(vocab, b, s, seed, mask_tail=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    if mask_tail:
        labels[0, -mask_tail:] = -1
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels.copy())})


def _policies(kind):
    if kind == "digital":
        return JMemPolicy(default=None), MemPolicy(default=None)
    kw = dict(mode="fast", var=0.02)
    return JMemPolicy(default=JDPEConfig(**kw)), MemPolicy(default=DPEConfig(**kw))


@pytest.fixture(scope="module")
def qwen():
    cfg, jcfg = get_smoke("qwen2-0.5b"), j_get_smoke("qwen2-0.5b")
    return jcfg, cfg, j_init_params(jcfg, jax.random.PRNGKey(0)), init_params(cfg, 0, device="cpu")


def _port_loss_and_grads(params, cfg, batch, **kw):
    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss = loss_fn(p, cfg, batch, **kw)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    return loss.detach(), grads


@pytest.mark.parametrize("kind", ["digital", "mem_fast"])
def test_loss_fn_matches_reference(qwen, kind):
    jcfg, cfg, jp, tp = qwen
    jpol, tpol = _policies(kind)
    jb, tb = _batch(cfg.vocab, 2, 16, 0, mask_tail=3)  # 32 rows a call, padded labels masked
    f = jax.value_and_grad(lambda p: j_loss_fn(
        p, jcfg, jb, policy=jpol, rng=jax.random.PRNGKey(3), compute_dtype=jnp.float32,
        loss_chunk=12))
    want_l, want_g = jax.jit(f)(jp)
    got_l, got_g = _port_loss_and_grads(tp, cfg, tb, policy=tpol, rng=PRNGKey(3),
                                        compute_dtype=torch.float32, loss_chunk=12)
    pairs = list(zip(jax.tree.leaves(want_g), got_g))
    assert len(pairs) == len(tree_leaves(tp))
    assert np.float32(got_l) == np.float32(want_l), (float(got_l), float(want_l))
    worst = max(max_rel(a, b) for a, b in pairs)
    assert worst <= 1e-5, worst


@pytest.mark.parametrize("kind", ["digital", "mem_fast"])
def test_remat_on_equals_off_bitwise(qwen, kind):
    _, cfg, _, tp = qwen
    _, tpol = _policies(kind)
    _, tb = _batch(cfg.vocab, 2, 16, 2)
    kw = dict(policy=tpol, rng=PRNGKey(1), compute_dtype=torch.float32, loss_chunk=8)
    l1, g1 = _port_loss_and_grads(tp, cfg, tb, remat=True, **kw)
    l0, g0 = _port_loss_and_grads(tp, cfg, tb, remat=False, **kw)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


def test_grad_compression_matches_reference():
    """Two compressed steps: the dequantised gradients and the bf16
    error-feedback buffers bitwise to the reference's jitted ``apply``."""
    rng = np.random.default_rng(3)
    g = {"w": (rng.standard_normal((40, 30)) * 1e-3).astype(np.float32),
         "b": (rng.standard_normal(300) * 1e-2).astype(np.float32)}
    jgc, tgc = JGradCompression(block=64), GradCompression(block=64)
    jst = {"ef": jgc.init(g)}
    tst = {"ef": tgc.init(tree_map(torch.from_numpy, g))}
    apply = jax.jit(jgc.apply)
    for _ in range(2):
        jd, jst = apply(g, jst)
        td, tst = tgc.apply(tree_map(torch.from_numpy, g), tst)
        for a, b in zip(jax.tree.leaves(jd), tree_leaves(td)):
            assert np.array_equal(np.asarray(a), b.numpy())
        for a, b in zip(jax.tree.leaves(jst["ef"]), tree_leaves(tst["ef"])):
            assert b.dtype == torch.bfloat16
            assert np.array_equal(np.asarray(a).view(np.uint16), b.view(torch.int16).numpy()
                                  .view(np.uint16))


def test_grad_compression_error_feedback():
    """The reference's test on the port: error feedback keeps the
    accumulated update unbiased."""
    gc = GradCompression(block=64)
    g = {"w": torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(0), (128,))))
         * 1e-3}
    state = {"ef": gc.init(g)}
    raw, comp = torch.zeros(128), torch.zeros(128)
    for _ in range(20):
        c, state = gc.apply(g, state)
        raw, comp = raw + g["w"], comp + c["w"]
    assert float(torch.linalg.norm(comp - raw) / torch.linalg.norm(raw)) < 0.05


def test_quant_dequant_bounded():
    x = torch.from_numpy(np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1000,))))
    d = _quant_dequant(x)
    assert float((d - x).abs().max()) <= float(x.abs().max()) / 127 + 1e-6


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "h2o-danube-1.8b"])
def test_synthetic_batch_matches_reference(arch):
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    for step in (0, 7):
        want = j_synthetic_batch(jcfg, 4, 24, step, seed=2)
        got = synthetic_batch(cfg, 4, 24, step, seed=2, device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == torch.int32
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


def test_synthetic_batch_keys_depend_on_the_process():
    """Pinned caveat of the reference (ROADMAP §C): a field's key folds in
    ``hash(name) & 0x7FFF``, and Python salts ``str`` hashes per process,
    so the batch of a step is the same only within one process."""
    outs = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed)
        out = subprocess.run(
            [sys.executable, "-c", 'print(hash("tokens") & 0x7FFF, hash("labels") & 0x7FFF)'],
            env=env, capture_output=True, text=True, timeout=60, check=True)
        outs.append(out.stdout.split())
    assert outs[0] != outs[1], outs
