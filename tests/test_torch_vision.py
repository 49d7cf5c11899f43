"""The port's vision-prefixed phi-3-vision against the JAX reference, on
the CPU, and the dense cache that a short ``max_len`` no longer crops.

phi3-vision-smoke (2 layers, d_model 128, 4 heads of 96 -- the smoke
config keeps phi-3-vision's head_dim --, vocab 512, a 16-patch prefix)
with the reference's weights (``init_params`` draws them bit for bit),
batch 2, prompt 8, patch embeddings ``0.02 * normal`` as the launcher
draws them, float32.  Classes:

* ``init_params``: bitwise; ``_embed_inputs`` (the patches ahead of the
  token embeddings): bitwise;
* ``forward(mode="prefill")`` over the 24 positions: max rel <= 1e-5;
* ``greedy_generate`` with ``extra_batch`` and an explicit ``max_len``:
  tokens equal, digital (first-token logits max rel <= 1e-5) and faithful
  (int8 on 32x32 arrays, ``dynamic_row`` ADC, one programmed state, the
  port's, on both sides; every logit row of the jitted reference's steps
  within rel-Fro 2e-2);
* the launcher: its patch embeddings bit-equal to the reference's draw;
  the reference's launcher raises at ``--smoke --gen 4`` (its
  ``greedy_generate`` default cache is shorter than the prefill), the
  port's passes ``max_len = vision_prefix + prompt_len + gen + 1`` and
  its tokens equal the reference's ``greedy_generate`` at that
  ``max_len`` (a pinned difference, ROADMAP §C);
* a dense cache shorter than the prefill raises ``ValueError`` on both
  sides (qwen2-smoke with ``max_len`` 4 after an 8-token prompt, and
  phi3-vision-smoke through ``greedy_generate``'s default ``max_len``);
* the trainer's loss trains both new families on the launcher's side
  inputs, the loss within rel 1e-5 of the reference's jitted loss; the
  ``ServeLoop`` refuses side inputs, as the reference's does.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs import get_smoke as j_get_smoke
from repro.core import DPEConfig as JDPEConfig
from repro.core import dpe as jdpe
from repro.core import spec as jspec
from repro.core.layers import MemPolicy as JMemPolicy
from repro.launch import serve as j_serve
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models.model import _embed_inputs as j_embed_inputs
from repro.models.model import forward as j_forward
from repro.serve import greedy_generate as j_greedy_generate
from repro.serve.engine import make_decode_step as j_make_decode_step
from repro.serve.engine import make_prefill_step as j_make_prefill_step
from repro_torch.configs import get, get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec
from repro_torch.launch import serve
from repro_torch.models import forward, init_params, loss_fn, program_params
from repro_torch.models import model as tmodel
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.serve import ServeConfig, ServeLoop, greedy_generate

torch.set_num_threads(1)

ARCH = "phi-3-vision-4.2b"
GEN = 3
DIGITAL_CLASS = 1e-5  # max rel, the digital float32 path
LOGIT_CLASS = 2e-2  # rel-Fro a logit row, faithful


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def build():
    jcfg, cfg = j_get_smoke(ARCH), get_smoke(ARCH)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    patches = np.array(0.02 * jax.random.normal(
        jax.random.PRNGKey(2), (2, cfg.vision_prefix, cfg.d_model)))
    return dict(jcfg=jcfg, cfg=cfg, jparams=j_init_params(jcfg, jax.random.PRNGKey(0)),
                params=init_params(cfg, 0, device="cpu"), prompts=prompts, patches=patches)


def test_init_params_and_embed_inputs_bitwise():
    m = build()
    want = jax.tree_util.tree_leaves_with_path(m["jparams"])
    got = tree_leaves(m["params"], paths=True)
    assert len(want) == len(got)
    for (jpath, a), (path, b) in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy()), (jax.tree_util.keystr(jpath), path)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        x = tmodel._embed_inputs(m["params"], m["cfg"], {
            "tokens": torch.from_numpy(m["prompts"]),
            "patch_embeds": torch.from_numpy(m["patches"])}, dtype)
        jx = j_embed_inputs(m["jparams"], m["jcfg"], {
            "tokens": jnp.asarray(m["prompts"]), "patch_embeds": jnp.asarray(m["patches"])},
            jdtype)
        assert x.shape == (2, 16 + 8, 128) and x.dtype == dtype
        assert np.array_equal(x.float().numpy(), np.asarray(jx.astype(jnp.float32)))


def test_forward_prefill_matches_reference():
    m = build()
    jh, jst = jax.jit(lambda p, b: j_forward(p, m["jcfg"], b, mode="prefill",
                                             compute_dtype=jnp.float32))(
        m["jparams"], {"tokens": jnp.asarray(m["prompts"]),
                       "patch_embeds": jnp.asarray(m["patches"])})
    h, st = forward(m["params"], m["cfg"], {"tokens": torch.from_numpy(m["prompts"]),
                                            "patch_embeds": torch.from_numpy(m["patches"])},
                    mode="prefill", compute_dtype=torch.float32)
    assert h.shape == (2, 24, 128)
    assert rel_max(h.numpy(), jh) <= DIGITAL_CLASS
    for k in ("k", "v"):
        assert st["seg0"][k].shape == jst["seg0"][k].shape == (2, 2, 24, 4, 96)
        assert rel_max(st["seg0"][k].numpy(), jst["seg0"][k]) <= DIGITAL_CLASS


def test_greedy_generate_digital_matches_reference():
    m = build()
    ml = 16 + 8 + GEN + 1
    jpol = JMemPolicy(default=None)
    want = np.asarray(j_greedy_generate(
        m["jparams"], m["jcfg"], jnp.asarray(m["prompts"]), GEN, policy=jpol, max_len=ml,
        compute_dtype=jnp.float32, extra_batch={"patch_embeds": jnp.asarray(m["patches"])}))
    first, _ = jax.jit(j_make_prefill_step(m["jcfg"], jpol, compute_dtype=jnp.float32,
                                           cache_dtype=jnp.float32))(
        m["jparams"], {"tokens": jnp.asarray(m["prompts"]),
                       "patch_embeds": jnp.asarray(m["patches"])})
    tokens, logits = greedy_generate(
        m["params"], m["cfg"], torch.from_numpy(m["prompts"]), GEN, max_len=ml,
        compute_dtype=torch.float32, extra_batch={"patch_embeds": torch.from_numpy(m["patches"])},
        collect_logits=True)
    assert np.array_equal(tokens.numpy(), want), (tokens.tolist(), want.tolist())
    assert rel_max(logits[:, 0].numpy(), first) <= DIGITAL_CLASS


def to_reference(tree):
    """The port's programmed state as the reference's (untimed) tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_reference(v) for k, v in tree.items()}
    return jdpe.PreparedWeight(jnp.asarray(tree.slices.numpy()), jnp.asarray(tree.scale.numpy()))


def test_greedy_generate_faithful_matches_reference():
    m = build()
    kw = dict(array_size=(32, 32), mode="faithful", adc_mode="dynamic_row", backend="auto")
    jpol = JMemPolicy(default=JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"),
                                         **kw))
    tpol = MemPolicy(default=DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"), **kw))
    gen, ml = 2, 16 + 4 + 2 + 1
    prompts = m["prompts"][:, :4]
    prog = program_params(m["params"], m["cfg"], tpol)
    jprog = to_reference(prog)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), m["params"])
    prefill = jax.jit(j_make_prefill_step(m["jcfg"], jpol, max_len=ml, compute_dtype=jnp.float32,
                                          cache_dtype=jnp.float32))
    decode = jax.jit(j_make_decode_step(m["jcfg"], jpol, compute_dtype=jnp.float32))
    logits, cache = prefill(jparams, {"tokens": jnp.asarray(prompts),
                                      "patch_embeds": jnp.asarray(m["patches"])}, jprog)
    rows, want = [logits], [jnp.argmax(logits, axis=-1)]
    for _ in range(gen):
        logits, cache = decode(jparams, cache, want[-1], jprog)
        rows.append(logits)
        want.append(jnp.argmax(logits, axis=-1))
    tokens, got = greedy_generate(
        m["params"], m["cfg"], torch.from_numpy(prompts), gen, policy=tpol, max_len=ml,
        compute_dtype=torch.float32, programmed=prog,
        extra_batch={"patch_embeds": torch.from_numpy(m["patches"])}, collect_logits=True)
    want = np.stack([np.asarray(w) for w in want], axis=1)
    assert np.array_equal(tokens.numpy(), want), (tokens.tolist(), want.tolist())
    for i, row in enumerate(rows):
        for b in range(2):
            assert rel_fro(got[b, i].numpy(), row[b]) <= LOGIT_CLASS, (b, i)


def test_launcher_side_inputs_and_pinned_max_len(capsys):
    """The reference's launcher raises for a vision model (C1: its cache is
    shorter than the prefill); the port's sizes the cache for the patch
    prefix and gives the reference's ``greedy_generate`` tokens at that
    ``max_len``."""
    m = build()
    args = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt_len", "8", "--gen", "4"]
    with pytest.raises(ValueError):
        j_serve.main(args)
    got = serve.main(args + ["--device", "cpu"])
    assert "generated (2, 5) tokens in" in capsys.readouterr().out
    extra = serve.side_inputs(m["cfg"], 2, "cpu")
    assert sorted(extra) == ["patch_embeds"]
    assert np.array_equal(extra["patch_embeds"].numpy(), m["patches"])
    prompts = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0, m["cfg"].vocab)
    want = np.asarray(j_greedy_generate(
        m["jparams"], m["jcfg"], prompts, 4, policy=JMemPolicy(default=None),
        max_len=16 + 8 + 4 + 1, compute_dtype=jnp.float32,
        extra_batch={"patch_embeds": jnp.asarray(m["patches"])}))
    assert got.shape == (2, 5) and np.array_equal(got.numpy(), want), (got.tolist(), want)


def test_short_cache_raises_on_both_sides():
    """C1: a dense cache shorter than the prefill raises ``ValueError`` (the
    port cropped the K / V silently before)."""
    jcfg, cfg = j_get_smoke("qwen2-0.5b"), get_smoke("qwen2-0.5b")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (1, 8)).astype(np.int32)
    with pytest.raises(ValueError):
        j_greedy_generate(j_init_params(jcfg, jax.random.PRNGKey(0)), jcfg,
                          jnp.asarray(prompts), 2, policy=JMemPolicy(default=None), max_len=4)
    with pytest.raises(ValueError, match="max_len 4 is shorter than the prefill's 8"):
        greedy_generate(init_params(cfg, 0, device="cpu"), cfg, torch.from_numpy(prompts), 2,
                        max_len=4)
    # a vision model through greedy_generate's default max_len (prompt + new + 1)
    m = build()
    with pytest.raises(ValueError):
        j_greedy_generate(m["jparams"], m["jcfg"], jnp.asarray(m["prompts"]), 2,
                          policy=JMemPolicy(default=None),
                          extra_batch={"patch_embeds": jnp.asarray(m["patches"])})
    with pytest.raises(ValueError, match="max_len 11 is shorter than the prefill's 24"):
        greedy_generate(m["params"], m["cfg"], torch.from_numpy(m["prompts"]), 2,
                        extra_batch={"patch_embeds": torch.from_numpy(m["patches"])})


def test_full_config_matches_reference():
    cfg, jcfg = get(ARCH), j_get(ARCH)
    for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "head_dim", "norm", "act", "rope_theta", "vision_prefix"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.param_count() == jcfg.param_count()
    assert (cfg.vision_prefix, cfg.vocab) == (576, 32064)


@pytest.mark.parametrize("arch", [ARCH, "whisper-tiny"])
def test_trainer_and_serve_loop_refuse_side_inputs(arch):
    """The trainer's loss trains both families with their side inputs (the
    name is from when it refused them): the loss within rel 1e-5 of the
    reference's jitted loss on the same batch, the gradients finite; the
    ``ServeLoop`` refuses side inputs, as the reference's does."""
    cfg, jcfg = get_smoke(arch), j_get_smoke(arch)
    params = init_params(cfg, 0, device="cpu")
    tokens = torch.arange(4, dtype=torch.int32)[None] * 7
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1), **serve.side_inputs(cfg, 1, "cpu")}
    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    loss = loss_fn(p, cfg, batch, compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    want = jax.jit(lambda p, b: j_loss_fn(p, jcfg, b, compute_dtype=jnp.float32))(
        tree_map(lambda t: jnp.asarray(t.numpy()), params),
        {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * abs(float(want))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with pytest.raises(NotImplementedError, match="side inputs"):
        ServeLoop(params, cfg, ServeConfig(device="cpu"))
