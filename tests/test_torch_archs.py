"""The port's mirror of ``tests/test_archs.py`` over the registry's ten
configs: the published widths, a smoke decode step, ``mem_fast`` on a
train loss, and the smoke train step of the first five archs (the other
five are ``tests/test_torch_archs_train.py``'s, to keep each file under a
minute).

Each arch's ``SMOKE`` config with random weights (``init_params(cfg,
0)``, the reference's draw bit for bit), float32, on the CPU.  The batch
is the reference test's, drawn with the port's threefry
(``repro_torch.core.prng``, the reference's bits): tokens and labels
``randint`` from ``PRNGKey(1)`` / ``PRNGKey(2)``, patch embeddings and
frames ``0.02 * normal`` from ``PRNGKey(3)`` / ``PRNGKey(4)`` in
bfloat16.  Classes:

* the full configs: layers, width, heads, KV heads, MLP width and vocab
  as the reference test's table, ``param_count`` equal to the
  reference's, and every field the reference's;
* a smoke train step (digital, loss chunks of 256, remat on): the loss
  finite and within rel 1e-5 of the reference's jitted loss on its own
  batch (the digital class; measured <= 1.4e-7), the gradient norm
  positive and finite;
* a smoke decode step on ``init_cache(cfg, 2, 64)``: logits (2, vocab),
  finite, ``pos`` 1;
* ``mem_fast`` (every projection but the router, int8, var 0.05) moves
  the train loss of qwen2-smoke and jamba-smoke off the digital loss by
  more than 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_arch_names
from repro.configs import get as j_get
from repro.configs import get_smoke as j_get_smoke
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs import get, get_smoke
from repro_torch.core import DPEConfig, MemPolicy
from repro_torch.core.prng import PRNGKey, normal, randint
from repro_torch.models import decode_step, init_cache, init_params, loss_fn
from repro_torch.models.common import tree_leaves

torch.set_num_threads(1)

ARCHS = all_arch_names()
TABLE = {
    "h2o-danube-1.8b": (24, 2560, 32, 8, 6912, 32000),
    "qwen2-0.5b": (24, 896, 14, 2, 4864, 151936),
    "qwen3-4b": (36, 2560, 32, 8, 9728, 151936),
    "qwen1.5-32b": (64, 5120, 40, 40, 27392, 152064),
    "rwkv6-1.6b": (24, 2048, 32, 32, 7168, 65536),
    "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 1536, 151936),
    "kimi-k2-1t-a32b": (61, 7168, 64, 8, 2048, 163840),
    "whisper-tiny": (4, 384, 6, 6, 1536, 51865),
    "jamba-v0.1-52b": (32, 4096, 32, 8, 14336, 65536),
    "phi-3-vision-4.2b": (32, 3072, 32, 32, 8192, 32064),
}


def port_batch(cfg, b=2, s=32):
    """The reference test's batch, drawn with the port's threefry."""
    batch = {"tokens": randint(PRNGKey(1), (b, s), 0, cfg.vocab),
             "labels": randint(PRNGKey(2), (b, s), 0, cfg.vocab)}
    if cfg.vision_prefix:
        batch["patch_embeds"] = (normal(PRNGKey(3), (b, cfg.vision_prefix, cfg.d_model))
                                 * 0.02).to(torch.bfloat16)
    if cfg.encoder is not None:
        batch["frames"] = (normal(PRNGKey(4), (b, cfg.encoder.n_frames, cfg.d_model))
                           * 0.02).to(torch.bfloat16)
    return batch


def ref_batch(cfg, b=2, s=32):
    """The reference test's batch (``tests/test_archs.py::_batch``)."""
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (b, s), 0, cfg.vocab),
             "labels": jax.random.randint(jax.random.PRNGKey(2), (b, s), 0, cfg.vocab)}
    if cfg.vision_prefix:
        batch["patch_embeds"] = (0.02 * jax.random.normal(
            jax.random.PRNGKey(3), (b, cfg.vision_prefix, cfg.d_model))).astype(jnp.bfloat16)
    if cfg.encoder is not None:
        batch["frames"] = (0.02 * jax.random.normal(
            jax.random.PRNGKey(4), (b, cfg.encoder.n_frames, cfg.d_model))).astype(jnp.bfloat16)
    return batch


def check_train_step(arch):
    """One smoke train step: the loss finite and within rel 1e-5 of the
    reference's, the gradient norm positive and finite."""
    cfg, jcfg = get_smoke(arch), j_get_smoke(arch)
    params = init_params(cfg, 0, device="cpu")
    p = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss = loss_fn(params, cfg, port_batch(cfg), compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, p, allow_unused=True)
    gnorm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads if g is not None))
    want = jax.jit(lambda p, b: j_loss_fn(p, jcfg, b, compute_dtype=jnp.float32))(
        j_init_params(jcfg, jax.random.PRNGKey(0)), ref_batch(jcfg))
    loss = float(loss.detach())
    assert np.isfinite(loss), arch
    assert abs(loss - float(want)) <= 1e-5 * abs(float(want)), (arch, loss, float(want))
    assert np.isfinite(float(gnorm)) and float(gnorm) > 0, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_assignment(arch):
    cfg, jcfg = get(arch), j_get(arch)
    l, d, h, kv, ff, v = TABLE[arch]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads) == (l, d, h)
    assert (cfg.n_kv_heads, cfg.d_ff, cfg.vocab) == (kv, ff, v)
    assert cfg.param_count() == jcfg.param_count()
    for f in dataclasses.fields(jcfg):
        want, got = getattr(jcfg, f.name), getattr(cfg, f.name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, f.name)
        else:
            assert got == want, (arch, f.name)
    if arch == "qwen3-moe-235b-a22b":
        assert cfg.moe.n_experts == 128 and cfg.moe.top_k == 8
    if arch == "kimi-k2-1t-a32b":
        assert cfg.moe.n_experts == 384 and cfg.moe.top_k == 8
        assert cfg.param_count() > 0.9e12
    if arch == "jamba-v0.1-52b":
        assert cfg.moe.n_experts == 16 and cfg.moe.top_k == 2
        kinds = [cfg.layer_kind(i)[0] for i in range(8)]
        assert kinds.count("attn") == 1 and kinds.count("ssm") == 7


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_matches_reference(arch):
    cfg, jcfg = get_smoke(arch), j_get_smoke(arch)
    for f in dataclasses.fields(jcfg):
        want, got = getattr(jcfg, f.name), getattr(cfg, f.name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, f.name)
        else:
            assert got == want, (arch, f.name)


@pytest.mark.parametrize("arch", ARCHS[:5])
def test_smoke_train_step(arch):
    check_train_step(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_step(arch):
    cfg = get_smoke(arch)
    params = init_params(cfg, 0, device="cpu")
    cache = init_cache(cfg, 2, 64, device="cpu")
    logits, cache2 = decode_step(params, cfg, cache, torch.zeros((2,), dtype=torch.int32))
    assert logits.shape == (2, cfg.vocab)
    assert torch.isfinite(logits).all()
    assert int(cache2["pos"][0]) == 1


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "jamba-v0.1-52b"])
def test_smoke_mem_policy_train(arch):
    """The paper's technique active end to end on a train loss."""
    cfg = get_smoke(arch)
    pol = MemPolicy(default=DPEConfig(mode="fast"), overrides=(("router", None),))
    params = init_params(cfg, 0, device="cpu")
    batch = port_batch(cfg)
    loss = loss_fn(params, cfg, batch, policy=pol, rng=PRNGKey(5), compute_dtype=torch.float32)
    loss_dig = loss_fn(params, cfg, batch, compute_dtype=torch.float32)
    assert torch.isfinite(loss)
    assert abs(float(loss) - float(loss_dig)) > 1e-6
