"""The port's whisper encoder-decoder against the JAX reference, on the
CPU, digital and float32 (``test_torch_encdec_faithful.py`` has
``mem_faithful``).

whisper-smoke (2 encoder and 2 decoder layers, d_model 64, 2 heads of 64
-- the smoke config keeps whisper-tiny's head_dim --, 64 frames, vocab
512) with the reference's weights (``init_params`` draws them bit for
bit), batch 2, prompt 8, frames ``0.02 * normal`` as the launcher draws
them.  Classes:

* ``init_params``: bitwise, ``encoder`` and ``cross`` included;
* ``xmath.sin`` / ``cos`` and ``_sinusoid``: bitwise against the
  reference's eager ``jnp.sin`` / ``jnp.cos`` / ``_sinusoid`` at (64, 64)
  and at whisper-tiny's (1,500, 384);
* ``gelu``: bitwise against the jitted ``jax.nn.gelu`` and the
  reference's ``activation``;
* an encoder layer, and the prefill's cross-attention (16 queries over 64
  frames through the dense scores, over 1,500 through
  ``attention_chunked``): max rel <= 1e-5;
* ``forward(mode="prefill")``, its states and ``cross_kv``, and a
  ``decode_step`` from each side's prefill cache: max rel <= 1e-5;
* ``greedy_generate``: tokens equal, first-token logits max rel <= 1e-5;
* the launcher's default mode (``--arch whisper-tiny --smoke``): tokens
  equal the reference launcher's, its frames bit-equal to the
  reference's draw.

The port's own contracts: programmed equals per-call programming, bit
for bit (``mem_fast`` and ``mem_faithful``); the programmed tree has the
reference's layout; the paged cache and the ``ServeLoop``
(``--requests``) refuse the encoder-decoder, as the reference's do, and
the trainer's loss trains it (``test_encdec_refusals_match_reference``):
within rel 1e-5 of the reference's jitted loss.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as j_get
from repro.configs import get_smoke as j_get_smoke
from repro.core.layers import MemPolicy as JMemPolicy
from repro.launch import serve as j_serve
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models import transformer as jtransformer
from repro.models.model import _sinusoid as j_sinusoid
from repro.models.model import decode_step as j_decode_step
from repro.models.model import forward as j_forward
from repro.models.model import init_paged_cache as j_init_paged_cache
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeLoop as JServeLoop
from repro.serve import greedy_generate as j_greedy_generate
from repro.serve.engine import make_prefill_step as j_make_prefill_step
from repro_torch.configs import get, get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec, xmath
from repro_torch.core.prng import PRNGKey
from repro_torch.launch import serve
from repro_torch.models import (
    decode_step,
    forward,
    init_cache,
    init_paged_cache,
    init_params,
    loss_fn,
    program_params,
)
from repro_torch.models import attention as tattention
from repro_torch.models import model as tmodel
from repro_torch.models.common import activation, gelu, layer_slice, tree_leaves, tree_map
from repro_torch.serve import ServeConfig, ServeLoop, greedy_generate
from repro_torch.serve.engine import make_prefill_step

torch.set_num_threads(1)

ARCH = "whisper-tiny"
GEN = 3
DIGITAL_CLASS = 1e-5  # max rel, the digital float32 path


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@functools.lru_cache(maxsize=None)
def build():
    jcfg, cfg = j_get_smoke(ARCH), get_smoke(ARCH)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    frames = np.asarray(0.02 * jax.random.normal(
        jax.random.PRNGKey(3), (2, cfg.encoder.n_frames, cfg.d_model)))
    return dict(jcfg=jcfg, cfg=cfg, jparams=j_init_params(jcfg, jax.random.PRNGKey(0)),
                params=init_params(cfg, 0, device="cpu"), prompts=prompts, frames=frames)


def batches(m):
    return ({"tokens": jnp.asarray(m["prompts"]), "frames": jnp.asarray(m["frames"])},
            {"tokens": torch.from_numpy(m["prompts"]), "frames": torch.from_numpy(m["frames"])})


def test_init_params_bitwise():
    m = build()
    want = jax.tree_util.tree_leaves_with_path(m["jparams"])
    got = tree_leaves(m["params"], paths=True)
    assert len(want) == len(got)
    for (jpath, a), (path, b) in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy()), (jax.tree_util.keystr(jpath), path)
    assert sorted(m["params"]) == ["blocks", "cross", "embed", "encoder", "final_norm",
                                   "lm_head"]
    assert sorted(m["params"]["cross"]) == ["k_proj", "norm", "o_proj", "q_proj", "v_proj"]
    # the smoke config keeps whisper-tiny's head_dim, 64: q is 2 x 64 wide
    assert m["params"]["encoder"]["blocks"]["attn"]["q_proj"]["w"].shape == (2, 64, 128)


@pytest.mark.parametrize("shape", [(64, 64), (1500, 384)])
def test_sin_cos_and_sinusoid_bitwise(shape):
    n, d = shape
    ang = np.array(jnp.arange(n, dtype=jnp.float32)[:, None]
                     * jnp.exp(-jnp.log(10000.0) * jnp.arange(d // 2, dtype=jnp.float32)
                               / (d // 2)))
    t = torch.from_numpy(ang)
    assert np.array_equal(xmath.sin(t).numpy(), np.asarray(jnp.sin(ang)))
    assert np.array_equal(xmath.cos(t).numpy(), np.asarray(jnp.cos(ang)))
    pos = np.broadcast_to(np.arange(n), (2, n))
    want = np.asarray(j_sinusoid(jnp.asarray(pos), d))
    got = tmodel._sinusoid(torch.from_numpy(pos.copy()), d, n)
    assert got.dtype == torch.float32 and got.shape == (2, n, d)
    assert np.array_equal(got.numpy(), want)
    # a decode step's positions, under a cache's longer bound
    pos1 = np.array([n - 1, 3])
    assert np.array_equal(tmodel._sinusoid(torch.from_numpy(pos1), d, n + 7).numpy(),
                          np.asarray(j_sinusoid(jnp.asarray(pos1), d)))


def test_sin_keeps_subnormals_as_xla():
    x = np.array([0.0, -0.0, 1e-40, -3e-39, 3e-38, 1e4, -7.5], np.float32)
    t = torch.from_numpy(x)
    assert np.array_equal(xmath.sin(t).numpy(), np.asarray(jnp.sin(x)))
    assert np.array_equal(xmath.cos(t).numpy(), np.asarray(jnp.cos(x)))


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_gelu_bitwise(scale):
    x = (np.random.default_rng(1).standard_normal((512, 1536)) * scale).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.gelu)(x))
    t = torch.from_numpy(x)
    assert np.array_equal(gelu(t).numpy(), want)
    assert np.array_equal(activation(t, "gelu").numpy(),
                          np.asarray(jax.jit(lambda v: jcommon.activation(v, "gelu"))(x)))


def test_encoder_layer_matches_reference():
    m = build()
    jcfg, cfg = m["jcfg"], m["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a[1], m["jparams"]["encoder"]["blocks"])
    p = layer_slice(m["params"]["encoder"]["blocks"], 1)
    x = np.random.default_rng(2).standard_normal((2, 64, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64), (2, 64))
    pol, jpol = MemPolicy(default=None), JMemPolicy(default=None)
    rng = jax.random.PRNGKey(0)

    def ref(x):  # the reference's enc_step (repro/models/model.py:680-697)
        h = jcommon.norm(x, jp["norm1"], jcfg.norm)
        y, _ = jattention.attention_block(jp["attn"], h, jcfg, policy=jpol,
                                          rng=jax.random.fold_in(rng, 1001), positions=pos,
                                          name="enc.attn")
        x = x + y
        h = jcommon.norm(x, jp["norm2"], jcfg.norm)
        return x + jtransformer._ffn_forward(jp, h, jcfg, policy=jpol,
                                             rng=jax.random.fold_in(rng, 2001), name="enc")

    want = jax.jit(ref)(jnp.asarray(x))
    got = tmodel._encoder_layer(p, torch.from_numpy(x), cfg, policy=pol, rng=PRNGKey(0),
                                idx=1, positions=torch.from_numpy(pos.copy()))
    assert rel_max(got.numpy(), want) <= DIGITAL_CLASS


@pytest.mark.parametrize("frames", [64, 1500])
def test_cross_attention_matches_reference(frames):
    """The prefill's cross-attention: 16 decoder queries over ``frames``
    encoder keys, non-causal (dense scores up to 1,024 keys, then
    ``attention_chunked``)."""
    m = build()
    jcfg, cfg = m["jcfg"], m["cfg"]
    jp = jax.tree_util.tree_map(lambda a: a[0], m["jparams"]["cross"])
    p = layer_slice(m["params"]["cross"], 0)
    g = np.random.default_rng(3)
    h = g.standard_normal((1, 16, 64)).astype(np.float32)
    kx, vx = (g.standard_normal((1, frames, 2, 64)).astype(np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(16), (1, 16))
    want, (wk, _) = jax.jit(lambda h, k, v: jattention.attention_block(
        jp, h, jcfg, policy=JMemPolicy(default=None), rng=jax.random.PRNGKey(0), positions=pos,
        name="dec.cross", kv_in=(k, v)))(h, kx, vx)
    got, (gk, _) = tattention.attention_block(
        p, torch.from_numpy(h), cfg, policy=MemPolicy(default=None), rng=PRNGKey(0),
        positions=torch.from_numpy(pos.copy()), name="dec.cross",
        kv_in=(torch.from_numpy(kx), torch.from_numpy(vx)), causal=False)
    assert np.array_equal(gk.numpy(), np.asarray(wk))  # no qk-norm, no RoPE on the keys
    assert rel_max(got.numpy(), want) <= DIGITAL_CLASS


def test_forward_prefill_and_decode_step_match_reference():
    m = build()
    jb, tb = batches(m)
    jh, jst = jax.jit(lambda p, b: j_forward(p, m["jcfg"], b, mode="prefill",
                                             compute_dtype=jnp.float32))(m["jparams"], jb)
    h, st = forward(m["params"], m["cfg"], tb, mode="prefill", compute_dtype=torch.float32)
    assert rel_max(h.numpy(), jh) <= DIGITAL_CLASS
    assert sorted(st) == ["cross_kv", "seg0"]
    for part in ("seg0", "cross_kv"):
        for k in ("k", "v"):
            got, want = st[part][k], jst[part][k]
            assert got.shape == want.shape, (part, k)
            assert rel_max(got.numpy(), want) <= DIGITAL_CLASS, (part, k)
    assert st["cross_kv"]["k"].shape == (2, 2, 64, 2, 64)
    jpol = JMemPolicy(default=None)
    _, jcache = jax.jit(j_make_prefill_step(m["jcfg"], jpol, max_len=12,
                                            compute_dtype=jnp.float32,
                                            cache_dtype=jnp.float32))(m["jparams"], jb)
    tok = np.array([3, 77], np.int32)
    jlogits, _ = jax.jit(lambda p, c, t: j_decode_step(p, m["jcfg"], c, t, policy=jpol,
                                                       compute_dtype=jnp.float32))(
        m["jparams"], jcache, jnp.asarray(tok))
    _, cache = make_prefill_step(m["cfg"], None, max_len=12, compute_dtype=torch.float32,
                                 cache_dtype=torch.float32)(m["params"], tb)
    assert cache["cross_kv"]["k"].dtype == torch.float32
    assert cache["blocks"]["seg0"]["k"].shape == (2, 2, 12, 2, 64)
    logits, cache = decode_step(m["params"], m["cfg"], cache, torch.from_numpy(tok),
                                compute_dtype=torch.float32)
    assert cache["pos"].tolist() == [9, 9]
    assert rel_max(logits.numpy(), jlogits) <= DIGITAL_CLASS


def test_greedy_generate_matches_reference():
    m = build()
    jb, tb = batches(m)
    jpol = JMemPolicy(default=None)
    want = np.asarray(j_greedy_generate(m["jparams"], m["jcfg"], jb["tokens"], GEN, policy=jpol,
                                        compute_dtype=jnp.float32,
                                        extra_batch={"frames": jb["frames"]}))
    first, _ = jax.jit(j_make_prefill_step(m["jcfg"], jpol, compute_dtype=jnp.float32,
                                           cache_dtype=jnp.float32))(m["jparams"], jb)
    tokens, logits = greedy_generate(m["params"], m["cfg"], tb["tokens"], GEN,
                                     compute_dtype=torch.float32,
                                     extra_batch={"frames": tb["frames"]}, collect_logits=True)
    assert tokens.dtype == torch.int32 and tokens.shape == (2, GEN + 1)
    assert np.array_equal(tokens.numpy(), want), (tokens.tolist(), want.tolist())
    assert np.isfinite(logits.numpy()).all()
    assert rel_max(logits[:, 0].numpy(), first) <= DIGITAL_CLASS


def test_launcher_default_mode_matches_reference(capsys):
    args = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt_len", "8", "--gen", "3"]
    want = np.asarray(j_serve.main(args))
    capsys.readouterr()
    got = serve.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert got.shape == (2, 4) and np.array_equal(got.numpy(), want), (got.tolist(), want)
    assert "generated (2, 4) tokens in" in out
    extra = serve.side_inputs(get_smoke(ARCH), 2, "cpu")
    assert sorted(extra) == ["frames"]
    assert np.array_equal(extra["frames"].numpy(), build()["frames"])


def test_full_config_matches_reference():
    cfg, jcfg = get(ARCH), j_get(ARCH)
    for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "head_dim", "norm", "act", "rope_theta"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert vars(cfg.encoder) == vars(jcfg.encoder)
    assert cfg.param_count() == jcfg.param_count()
    assert (cfg.encoder.n_layers, cfg.encoder.n_frames, cfg.vocab) == (4, 1500, 51865)


@pytest.mark.parametrize("mode", ["fast", "faithful"])
def test_programmed_equals_per_call(mode):
    """One prompt of 4 tokens, 2 new, under int8 on 32x32 arrays:
    programmed once, or on every call from the same keys, bit for bit."""
    m = build()
    cfg = m["cfg"]
    pol = MemPolicy(default=DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"),
                                      array_size=(32, 32), mode=mode, adc_mode="dynamic_row",
                                      backend="auto"))
    prog = program_params(m["params"], cfg, pol)
    assert sorted(prog) == ["blocks", "cross", "encoder", "lm_head"]
    assert sorted(prog["encoder"]["blocks"]) == ["attn", "mlp"]
    assert sorted(prog["cross"]) == ["k_proj", "o_proj", "q_proj", "v_proj"]
    frames = torch.from_numpy(m["frames"][:1])

    def run(**kw):
        return greedy_generate(m["params"], cfg, torch.from_numpy(m["prompts"][:1, :4]), 2,
                               policy=pol, compute_dtype=torch.float32,
                               extra_batch={"frames": frames}, collect_logits=True, **kw)

    a, la = run(programmed=prog)
    b, lb = run(weight_stationary=False)
    assert torch.equal(a, b) and torch.equal(la, lb)


def test_init_cache_holds_cross_kv():
    cfg = build()["cfg"]
    cache = init_cache(cfg, 3, 16, dtype=torch.float32, device="cpu")
    assert cache["cross_kv"]["k"].shape == (2, 3, 64, 2, 64)
    assert cache["blocks"]["seg0"]["k"].shape == (2, 3, 16, 2, 64)


def test_encdec_refusals_match_reference():
    m = build()
    cfg, jcfg = m["cfg"], m["jcfg"]
    with pytest.raises(NotImplementedError, match="all-attention"):
        init_paged_cache(cfg, 2, 32, 8, 9, device="cpu")
    with pytest.raises(NotImplementedError, match="all-attention"):
        j_init_paged_cache(jcfg, 2, 32, 8, 9)
    with pytest.raises(NotImplementedError, match="side inputs"):
        ServeLoop(m["params"], cfg, ServeConfig(device="cpu"))
    with pytest.raises(NotImplementedError, match="side inputs"):
        JServeLoop(m["jparams"], jcfg, JServeConfig())
    with pytest.raises(NotImplementedError, match="side inputs"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2"])
    # the trainer trains it (the test's name is from when it refused it): the
    # loss within rel 1e-5 of the reference's jitted loss, the gradients finite
    jb, tb = batches(m)
    p = tree_map(lambda t: t.clone().requires_grad_(True), m["params"])
    loss = loss_fn(p, cfg, {**tb, "labels": tb["tokens"]}, compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    want = jax.jit(lambda p, b: j_loss_fn(p, jcfg, b, compute_dtype=jnp.float32))(
        m["jparams"], {**jb, "labels": jb["tokens"]})
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * abs(float(want))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
