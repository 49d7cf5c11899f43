"""The port's hybrid jamba on its dense serving path against the JAX
reference, on the CPU.

jamba-smoke (one period of 8 layers: attention at in-group index 4, Mamba
elsewhere, MoE over 4 experts top 2 on the odd indices; d_model 128,
vocab 512) and the same period with the dense MLP in every layer
(``hybrid_moe_idx=()``, the cut the full-width period takes on one H100),
the reference's weights (``init_params`` draws them bit for bit), batch
2, prompt 8, float32, digital.  Classes:

* ``init_params``: bitwise, every leaf of every ``l{j}`` subtree;
* ``forward`` in prefill mode (digital): hidden states, K / V and the
  Mamba states max rel <= 1e-5; a dense ``decode_step`` from each side's
  prefill cache, logits max rel <= 1e-5;
* ``greedy_generate`` (3 new tokens, digital): tokens equal, the
  first-token logits max rel <= 1e-5 (``mem_faithful`` is
  ``test_torch_hybrid_faithful.py``'s);
* the launcher's default mode, ``--arch jamba-v0.1-52b --smoke
  --device cpu`` (digital): tokens equal the reference launcher's;
* the surfaces that refuse a hybrid as the reference's do: the paged
  cache, chunked prefill and speculative verify, the ``ServeLoop`` and
  so the launcher's ``--requests``.

The port's own contract: an 8-token prefill then decoding equals
decoding every token, tokens equal and logits within max rel 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.layers import MemPolicy as JMemPolicy
from repro.launch import serve as j_serve
from repro.models import init_params as j_init_params
from repro.models import transformer as jtransformer
from repro.models.model import decode_step as j_decode_step
from repro.models.model import forward as j_forward
from repro.models.model import init_paged_cache as j_init_paged_cache
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeLoop as JServeLoop
from repro.serve import greedy_generate as j_greedy_generate
from repro.serve.engine import make_prefill_step as j_make_prefill_step
from repro_torch.configs import get_smoke
from repro_torch.core import MemPolicy
from repro_torch.launch import serve
from repro_torch.models import (
    decode_step,
    forward,
    init_cache,
    init_paged_cache,
    init_params,
)
from repro_torch.models import transformer as ttransformer
from repro_torch.models.common import layer_slice, tree_leaves
from repro_torch.serve import ServeConfig, ServeLoop, greedy_generate
from repro_torch.serve.engine import make_prefill_step

torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"
VARIANTS = ["moe", "dense"]  # jamba-smoke as published, and with hybrid_moe_idx=()
GEN = 3


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@functools.lru_cache(maxsize=None)
def build(variant):
    jcfg, cfg = j_get_smoke(ARCH), get_smoke(ARCH)
    if variant == "dense":
        jcfg, cfg = jcfg.replace(hybrid_moe_idx=()), cfg.replace(hybrid_moe_idx=())
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=j_init_params(jcfg, jax.random.PRNGKey(0)),
                params=init_params(cfg, 0, device="cpu"), prompts=prompts)


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_params_bitwise(variant):
    m = build(variant)
    want = jax.tree_util.tree_leaves_with_path(m["jparams"])
    got = tree_leaves(m["params"], paths=True)
    assert len(want) == len(got)
    for (jpath, a), (path, b) in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy()), (jax.tree_util.keystr(jpath), path)
    group = layer_slice(m["params"]["blocks"]["seg0"], 0)
    assert sorted(group) == [f"l{j}" for j in range(8)]
    assert "attn" in group["l4"] and "ssm" in group["l0"]
    assert ("moe" in group["l1"]) == (variant == "moe") and "mlp" in group["l0"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_and_decode_step_match_reference(variant):
    m = build(variant)
    batch = {"tokens": jnp.asarray(m["prompts"])}
    jh, jst = jax.jit(lambda p, b: j_forward(p, m["jcfg"], b, mode="prefill",
                                             compute_dtype=jnp.float32))(m["jparams"], batch)
    h, st = forward(m["params"], m["cfg"], {"tokens": torch.from_numpy(m["prompts"])},
                    mode="prefill", compute_dtype=torch.float32)
    assert rel_max(h.numpy(), jh) <= 1e-5
    for j, keys in ((0, ("h", "conv")), (4, ("k", "v")), (7, ("h", "conv"))):
        for k in keys:
            got, want = st["seg0"][f"l{j}"][k], jst["seg0"][f"l{j}"][k]
            assert got.shape == want.shape, (j, k)
            assert rel_max(got.numpy(), want) <= 1e-5, (j, k)
    jpol = JMemPolicy(default=None)
    _, jcache = jax.jit(j_make_prefill_step(m["jcfg"], jpol, compute_dtype=jnp.float32,
                                            cache_dtype=jnp.float32))(m["jparams"], batch)
    tok = np.array([3, 77], np.int32)
    jlogits, _ = jax.jit(lambda p, c, t: j_decode_step(p, m["jcfg"], c, t, policy=jpol,
                                                       compute_dtype=jnp.float32))(
        m["jparams"], jcache, jnp.asarray(tok))
    _, cache = make_prefill_step(m["cfg"], None, compute_dtype=torch.float32,
                                 cache_dtype=torch.float32)(
        m["params"], {"tokens": torch.from_numpy(m["prompts"])})
    assert cache["blocks"]["seg0"]["l0"]["h"].dtype == torch.float32
    logits, cache = decode_step(m["params"], m["cfg"], cache, torch.from_numpy(tok),
                                compute_dtype=torch.float32)
    assert cache["pos"].tolist() == [9, 9]
    assert rel_max(logits.numpy(), jlogits) <= 1e-5


@pytest.mark.parametrize("variant", VARIANTS)
def test_greedy_generate_matches_reference(variant):
    m = build(variant)
    jpol = JMemPolicy(default=None)
    prompts = jnp.asarray(m["prompts"])
    want = np.asarray(j_greedy_generate(m["jparams"], m["jcfg"], prompts, GEN, policy=jpol,
                                        compute_dtype=jnp.float32))
    first, _ = jax.jit(j_make_prefill_step(m["jcfg"], jpol, compute_dtype=jnp.float32,
                                           cache_dtype=jnp.float32))(
        m["jparams"], {"tokens": prompts})
    tokens, logits = greedy_generate(m["params"], m["cfg"], torch.from_numpy(m["prompts"]), GEN,
                                     compute_dtype=torch.float32, collect_logits=True)
    assert tokens.dtype == torch.int32 and tokens.shape == (2, GEN + 1)
    assert np.array_equal(tokens.numpy(), want), (tokens.tolist(), want.tolist())
    assert np.isfinite(logits.numpy()).all()
    assert rel_max(logits[:, 0].numpy(), first) <= 1e-5


def test_launcher_default_mode_matches_reference(capsys):
    args = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt_len", "8", "--gen", "4"]
    want = np.asarray(j_serve.main(args))
    capsys.readouterr()
    got = serve.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert got.shape == (2, 5) and np.array_equal(got.numpy(), want), (got.tolist(), want)
    assert "generated (2, 5) tokens in" in out


def test_prefill_then_decode_equals_decoding_every_token():
    m = build("moe")
    cfg, params = m["cfg"], m["params"]
    prompt = torch.from_numpy(m["prompts"])
    tokens, logits = greedy_generate(params, cfg, prompt, 2, compute_dtype=torch.float32,
                                     collect_logits=True)
    cache = init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    for i in range(prompt.shape[1]):
        step, cache = decode_step(params, cfg, cache, prompt[:, i], compute_dtype=torch.float32)
    rows, out = [step], [torch.argmax(step, dim=-1)]
    for _ in range(2):
        step, cache = decode_step(params, cfg, cache, out[-1], compute_dtype=torch.float32)
        rows.append(step)
        out.append(torch.argmax(step, dim=-1))
    assert torch.equal(tokens, torch.stack(out, 1).to(torch.int32))
    assert cache["pos"].tolist() == [10, 10]
    assert rel_max(logits.numpy(), torch.stack(rows, 1).numpy()) <= 1e-4


def test_hybrid_refusals_match_reference():
    m = build("moe")
    cfg, jcfg = m["cfg"], m["jcfg"]
    with pytest.raises(NotImplementedError, match="all-attention"):
        ServeLoop(m["params"], cfg, ServeConfig(device="cpu"))
    with pytest.raises(NotImplementedError, match="all-attention"):
        JServeLoop(m["jparams"], jcfg, JServeConfig())
    with pytest.raises(NotImplementedError, match="all-attention"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2"])
    with pytest.raises(NotImplementedError, match="all-attention"):
        init_paged_cache(cfg, 2, 32, 8, 9, device="cpu")
    with pytest.raises(NotImplementedError, match="all-attention"):
        j_init_paged_cache(jcfg, 2, 32, 8, 9)
    p = layer_slice(m["params"]["blocks"]["seg0"], 0)
    kw = dict(policy=MemPolicy(default=None), rng=None, state={}, prepared=None)
    for port, ref, extra in (
            (ttransformer.block_chunk, jtransformer.block_chunk,
             dict(bt_row=None, start=0, n_valid=1, positions=None)),
            (ttransformer.block_verify, jtransformer.block_verify,
             dict(pos=None, block_tables=None))):
        with pytest.raises(NotImplementedError, match="all-attention"):
            port(p, torch.zeros((1, 2, cfg.d_model)), cfg, 0, **kw, **extra)
        with pytest.raises(NotImplementedError, match="all-attention"):
            ref({}, jnp.zeros((1, 2, cfg.d_model)), jcfg, 0, **kw, **extra)
