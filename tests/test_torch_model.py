"""The port's serving model steps against the JAX reference.

qwen2-smoke (2 layers, d_model 128, 7 heads, 1 KV head, hd 18) with the
reference's random weights and its programmed crossbar state carried
across (``repro_torch.models.convert``).  Both sides run the same chunked
prefill of two prompts into a paged arena with a non-trivial block
layout, then three slot-parallel decode steps fed the same tokens, with
``compute_dtype=float32`` as served.  Logits agree:

* digital and ``mem_fast``: max rel <= 1e-5.  ``mem_fast`` runs here
  with a float32 store: with the bf16 store of ``make_policy`` the
  reference disagrees with itself, eager against compiled, by one bf16
  ulp of a product (``test_torch_core.py`` holds the port bitwise to the
  eager reference there, and ``test_torch_serve.py`` serves the bf16
  policy with tokens equal);
* ``mem_faithful`` (``dynamic_row`` ADC): rel-Fro <= 1e-3.  The
  reference's scanned layers are compiled, and XLA rewrites the
  quantiser's ``x / s`` to ``x * (1/s)`` (DESIGN.md §4) while the port
  divides, so a few quantiser codes sit on the other side of a rounding
  boundary; the test reports how many for the first projection.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import DPEConfig as JDPEConfig
from repro.core import dpe as jdpe
from repro.core import spec as jspec
from repro.core.layers import MemPolicy as JMemPolicy
from repro.models import init_params as j_init_params
from repro.models import program_params as j_program_params
from repro.models.model import decode_step as j_decode_step
from repro.models.model import init_paged_cache as j_init_paged_cache
from repro.models.model import prefill_chunk_step as j_prefill_chunk_step
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec
from repro_torch.core import dpe as tdpe
from repro_torch.models import convert, decode_step, init_paged_cache, prefill_chunk_step
from repro_torch.models import program_params, programmed_byte_size

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

ARRAY = (32, 32)


def policies(kind):
    """(reference policy, port policy) of one serving mode."""
    if kind == "digital":
        return JMemPolicy(default=None), MemPolicy(default=None)
    kw = dict(array_size=ARRAY, mode="fast" if kind == "mem_fast" else "faithful",
              adc_mode="dynamic_row", backend="auto")
    return (
        JMemPolicy(default=JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"), **kw)),
        MemPolicy(default=DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"), **kw)),
    )


@pytest.fixture(scope="module")
def model():
    """The reference's smoke params with random biases, as numpy."""
    cfg = j_get_smoke("qwen2-0.5b")
    params = jax.tree.map(np.asarray, j_init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    attn = params["blocks"]["seg0"]["attn"]
    for k in ("q_proj", "k_proj", "v_proj"):
        attn[k]["b"] = (rng.standard_normal(attn[k]["b"].shape) * 0.1).astype(np.float32)
    return cfg, params


def test_smoke_config_is_the_reference_config():
    assert get_smoke("qwen2-0.5b") .__dict__ == j_get_smoke("qwen2-0.5b").__dict__


# two prompts: slot 0 prefills in two chunks (8 + 3), slot 1 in one (6)
PROMPTS = {0: 11, 1: 6}
CHUNK = 8
BLOCK_TABLES = np.array([[3, 1, 0, 0], [6, 2, 0, 0]], np.int32)


def _run_reference(cfg, params, prog, jpol, prompts):
    """The reference's steps, compiled once each as its ServeLoop does."""
    kw = dict(policy=jpol, rng=jax.random.PRNGKey(0), compute_dtype=jnp.float32)
    chunk_step = jax.jit(lambda p, c, t, s, st, nv, f, pr: j_prefill_chunk_step(
        p, cfg, c, t, s, st, nv, f, programmed=pr, **kw))
    step = jax.jit(lambda p, c, t, pr, a: j_decode_step(
        p, cfg, c, t, programmed=pr, active=a, **kw))
    cache = j_init_paged_cache(cfg, 2, 32, 8, 9, dtype=jnp.float32)
    cache["block_tables"] = jnp.asarray(BLOCK_TABLES)
    logits, tokens = [], []
    for slot, toks in prompts.items():
        for start in range(0, len(toks), CHUNK):
            nv = min(CHUNK, len(toks) - start)
            chunk = np.zeros((CHUNK,), np.int32)
            chunk[:nv] = toks[start:start + nv]
            out, cache = chunk_step(
                params, cache, jnp.asarray(chunk), jnp.int32(slot), jnp.int32(start),
                jnp.int32(nv), jnp.bool_(start + nv >= len(toks)), prog)
        logits.append(np.asarray(out))
        tokens.append(int(np.argmax(out[0])))
    step_tokens = [np.array(tokens, np.int32)]
    for _ in range(3):
        out, cache = step(params, cache, jnp.asarray(step_tokens[-1]), prog,
                          jnp.array([True, True]))
        logits.append(np.asarray(out))
        step_tokens.append(np.argmax(np.asarray(out), axis=-1).astype(np.int32))
    return logits, step_tokens


def _run_port(cfg, params, prog, tpol, prompts, step_tokens):
    cache = init_paged_cache(cfg, 2, 32, 8, 9, dtype=torch.float32, device="cpu")
    cache["block_tables"] = torch.from_numpy(BLOCK_TABLES.copy())
    logits = []
    for slot, toks in prompts.items():
        for start in range(0, len(toks), CHUNK):
            nv = min(CHUNK, len(toks) - start)
            chunk = np.zeros((CHUNK,), np.int32)
            chunk[:nv] = toks[start:start + nv]
            out, cache = prefill_chunk_step(
                params, cfg, cache, torch.from_numpy(chunk), slot, start, nv,
                start + nv >= len(toks), policy=tpol, compute_dtype=torch.float32,
                programmed=prog)
        logits.append(out.numpy())
    for toks in step_tokens[:-1]:  # the reference's tokens, teacher-forced
        out, cache = decode_step(
            params, cfg, cache, torch.from_numpy(toks), policy=tpol,
            compute_dtype=torch.float32, programmed=prog, active=torch.tensor([True, True]))
        logits.append(out.numpy())
    assert cache["pos"].tolist() == [PROMPTS[0] + 3, PROMPTS[1] + 3]
    return logits


def _quantiser_flips(cfg, params, jpol):
    """Input codes of the first projection that differ between the
    reference's compiled ``prepare_input`` and the port's."""
    dcfg = jpol.default
    x = np.random.default_rng(1).standard_normal((16, cfg.d_model)).astype(np.float32)
    xs_j, _ = jax.jit(jdpe.prepare_input, static_argnums=1)(jnp.asarray(x), dcfg)
    tcfg = DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"), array_size=ARRAY)
    xs_t, _ = tdpe.prepare_input(torch.from_numpy(x), tcfg)
    return int((np.asarray(xs_j) != xs_t.numpy()).any(axis=0).sum()), x.size


@pytest.mark.parametrize("kind", ["digital", "mem_fast", "mem_faithful"])
def test_prefill_and_decode_logits_match_reference(model, kind):
    jcfg, params_np = model
    cfg = get_smoke("qwen2-0.5b")
    jpol, tpol = policies(kind)
    params_j = jax.tree.map(jnp.asarray, params_np)
    prog_j = j_program_params(params_j, jcfg, jpol, jax.random.PRNGKey(0))
    prog_np = jax.tree.map(np.asarray, prog_j)
    params_t = convert.params_from_numpy(params_np, "cpu")
    prog_t = convert.programmed_from_numpy(prog_np, "cpu")
    if kind != "digital":
        # the port programs the same tree structure and byte size itself
        own = program_params(params_t, cfg, tpol)
        assert programmed_byte_size(own) == programmed_byte_size(prog_t) > 0
    rng = np.random.default_rng(2)
    prompts = {s: rng.integers(0, cfg.vocab, n).astype(np.int32) for s, n in PROMPTS.items()}
    ref, step_tokens = _run_reference(jcfg, params_j, prog_j, jpol, prompts)
    got = _run_port(cfg, params_t, prog_t, tpol, prompts, step_tokens)
    assert len(got) == len(ref) == 5
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and np.isfinite(a).all()
        if kind == "mem_faithful":
            err = np.linalg.norm(a.astype(np.float64) - b) / np.linalg.norm(b)
            assert err <= 1e-3, (i, err)
        else:
            err = np.abs(a.astype(np.float64) - b).max() / np.abs(b).max()
            assert err <= 1e-5, (i, err)
    if kind == "mem_faithful":
        flips, n = _quantiser_flips(cfg, params_np, jpol)
        print(f"faithful: quantiser codes flipped by x*(1/s) in the reference: {flips} of {n}")
