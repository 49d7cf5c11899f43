"""The port's dense serving path against the JAX reference:
``prng.randint``, the dense attention functions, ``forward`` (prefill)
and ``greedy_generate``.

qwen2-smoke with the reference's weights (``init_params`` draws them bit
for bit); batch 2, prompt 8, float32.  The hardware policies are
``test_torch_serve.py``'s (32x32 arrays, ``dynamic_row`` ADC, float32
store for ``mem_fast``).  Classes:

* ``randint``: bitwise to ``jax.random.randint``.
* ``attention_dense`` / ``attention_decode`` / ``attention_chunked``: max
  rel (the largest difference over the largest value) <= 1e-6 in
  float32, and in bf16 at most one bf16 step, 2**-8.
* ``forward`` in prefill mode, hidden states and K / V: digital and
  ``mem_fast`` max rel <= 1e-5, ``mem_faithful`` rel-Fro <= 1e-3.
* ``greedy_generate`` (4 new tokens): tokens equal for digital,
  ``mem_fast`` and ``mem_faithful``, the first-token logits in the same
  classes; a sampled run token-equal.

Both sides serve the same programmed state: the port's, which is the
reference's eager programming bit for bit.  The reference programs
under ``jit`` in its own ``program_params``, which moves some noisy slice
values by a few ulps (``test_reference_compiled_programming_departs_
from_its_eager_programming``, ROADMAP §C), and the faithful engine turns
such ulps into quantiser codes.
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
from repro.models import attention as jatt
from repro.models import init_params as j_init_params
from repro.models.model import forward as j_forward
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import greedy_generate as j_greedy_generate
from repro.serve.engine import make_prefill_step as j_make_prefill_step
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, prng, spec
from repro_torch.core import dpe as tdpe
from repro_torch.models import attention as tatt
from repro_torch.models import convert, forward, init_params, program_params
from repro_torch.serve import SamplingParams, greedy_generate

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

KINDS = ["digital", "mem_fast", "mem_faithful"]
GEN = 4


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check_class(kind, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    if kind == "mem_faithful":
        assert rel_fro(got, want) <= 1e-3
    else:
        assert rel_max(got, want) <= 1e-5


def policies(kind):
    """(reference, port) policy of ``test_torch_serve.py``'s classes."""
    if kind == "digital":
        return JMemPolicy(default=None), MemPolicy(default=None)
    kw = dict(array_size=(32, 32), mode="fast" if kind == "mem_fast" else "faithful",
              adc_mode="dynamic_row", backend="auto")
    return (
        JMemPolicy(default=JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"), **kw)),
        MemPolicy(default=DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"), **kw)),
    )


def to_reference(tree):
    """The port's programmed state as the reference's (untimed) tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_reference(v) for k, v in tree.items()}
    if isinstance(tree, tdpe.PreparedWeight):
        return jdpe.PreparedWeight(jnp.asarray(tree.slices.numpy()), jnp.asarray(tree.scale.numpy()))
    return jdpe.FoldedWeight(jnp.asarray(tree.w_eff.numpy()))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = j_get_smoke("qwen2-0.5b"), get_smoke("qwen2-0.5b")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    params = init_params(cfg, 0, device="cpu")
    progs = {kind: program_params(params, cfg, policies(kind)[1]) for kind in KINDS}
    return dict(jcfg=jcfg, jparams=j_init_params(jcfg, jax.random.PRNGKey(0)), cfg=cfg,
                params=params, prompts=prompts, progs=progs,
                jprogs={k: to_reference(v) for k, v in progs.items()})


# ---------------------------------------------------------------------------
# prng.randint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shape,lo,hi", [
    (1, (4, 16), 0, 512),  # the launcher's prompts at qwen2-smoke
    (1, (4, 16), 0, 151936),  # ... and at qwen2-0.5b's vocab
    (0, (3, 5), -7, 9),
    (3, (2, 2), 5, 5),  # empty range: minval
    (7, (1000,), 0, 2**31 - 1),  # span past 2**16: the multiplier wraps
    (2, (9,), -100, 70000),
])
def test_randint_bitwise_to_jax(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))
    got = prng.randint(prng.PRNGKey(seed), shape, lo, hi)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# dense attention
# ---------------------------------------------------------------------------

def _qkv(seed, b, sq, skv, h, kv, dh):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return mk(b, sq, h, dh), mk(b, skv, kv, dh), mk(b, skv, kv, dh)


def _as(dtype, *arrays):
    j = tuple(jnp.asarray(a, dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32)
              for a in arrays)
    t = tuple(convert.to_tensor(np.asarray(a), "cpu") for a in j)
    return j, t


def _check(dtype, got, want):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert rel_max(got, want) <= (1e-6 if dtype == "f32" else 2.0**-8)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("q_off,window,causal", [(0, 0, True), (5, 0, True), (0, 6, True),
                                                 (0, 0, False)])
def test_attention_dense_matches_reference(dtype, q_off, window, causal):
    q, k, v = _qkv(0, 2, 9, 9 + q_off, 7, 1, 18)
    (jq, jk, jv), (tq, tk, tv) = _as(dtype, q, k, v)
    want = jatt.attention_dense(jq, jk, jv, q_off=q_off, window=window, causal=causal)
    got = tatt.attention_dense(tq, tk, tv, q_off=q_off, window=window, causal=causal)
    _check(dtype, got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 5])
def test_attention_decode_matches_reference(dtype, window):
    """Three slots at positions 0, 9 and 23 of a 24-position cache."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 14, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    pos = np.array([0, 9, 23], np.int32)
    (jq, jk, jv), (tq, tk, tv) = _as(dtype, q, kc, vc)
    want = jatt.attention_decode(jq, jk, jv, jnp.asarray(pos), window=window)
    got = tatt.attention_decode(tq, tk, tv, torch.from_numpy(pos), window=window)
    _check(dtype, got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_chunked_matches_reference(dtype):
    """S = 1,100, above ``attention_block``'s dense threshold: three
    512-query chunks on the triangular schedule (query chunk i scans key
    chunks 0..i); the masked full scan gives the same values."""
    q, k, v = _qkv(2, 1, 1100, 1100, 4, 2, 8)
    (jq, jk, jv), (tq, tk, tv) = _as(dtype, q, k, v)
    want = jatt.attention_chunked(jq, jk, jv, schedule="tri")
    got = tatt.attention_chunked(tq, tk, tv, schedule="tri")
    _check(dtype, got, want)
    _check(dtype, got, tatt.attention_chunked(tq, tk, tv, schedule="masked").float().numpy())


def test_reference_tri_schedule_assumes_equal_chunks():
    """Pinned reference caveat (ROADMAP §C): the triangular schedule lets
    query chunk i scan key chunks 0..i, which covers its keys only when
    ``q_chunk == kv_chunk``.  ``forward`` past 16,384 tokens takes
    ``q_chunk = ceil(S / 32) > kv_chunk = 512`` and drops keys; the port
    computes what the reference computes (here at q_chunk 4, kv_chunk 2:
    equal to it within 1e-6, and both away from the masked full scan)."""
    q, k, v = _qkv(4, 1, 16, 16, 2, 1, 4)
    (jq, jk, jv), (tq, tk, tv) = _as("f32", q, k, v)
    kw = dict(q_chunk=4, kv_chunk=2)
    want = jatt.attention_chunked(jq, jk, jv, schedule="tri", **kw)
    got = tatt.attention_chunked(tq, tk, tv, schedule="tri", **kw)
    _check("f32", got, want)
    masked = tatt.attention_chunked(tq, tk, tv, schedule="masked", **kw).numpy()
    _check("f32", torch.from_numpy(masked), jatt.attention_dense(jq, jk, jv))
    assert rel_max(got.numpy(), masked) > 0.1


# ---------------------------------------------------------------------------
# forward (prefill) and greedy_generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_forward_prefill_matches_reference(model, kind):
    """Hidden states (B, S, d) after the final norm and every layer's K / V
    (steps, B, S, KV, hd)."""
    m = model
    jpol, tpol = policies(kind)
    jh, jst = jax.jit(lambda p, b, pr: j_forward(
        p, m["jcfg"], b, policy=jpol, rng=jax.random.PRNGKey(0), mode="prefill",
        compute_dtype=jnp.float32, programmed=pr))(
        m["jparams"], {"tokens": jnp.asarray(m["prompts"])}, m["jprogs"][kind])
    h, st = forward(m["params"], m["cfg"], {"tokens": torch.from_numpy(m["prompts"])},
                    policy=tpol, mode="prefill", compute_dtype=torch.float32,
                    programmed=m["progs"][kind])
    for got, want in [(h, jh), (st["seg0"]["k"], jst["seg0"]["k"]),
                      (st["seg0"]["v"], jst["seg0"]["v"])]:
        check_class(kind, got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_greedy_generate_matches_reference(model, kind):
    m = model
    jpol, tpol = policies(kind)
    jprog = m["jprogs"][kind]
    want = np.asarray(j_greedy_generate(m["jparams"], m["jcfg"], jnp.asarray(m["prompts"]), GEN,
                                        policy=jpol, compute_dtype=jnp.float32,
                                        programmed=jprog))
    first, _ = jax.jit(j_make_prefill_step(m["jcfg"], jpol, compute_dtype=jnp.float32,
                                           cache_dtype=jnp.float32))(
        m["jparams"], {"tokens": jnp.asarray(m["prompts"])}, jprog)
    tokens, logits = greedy_generate(m["params"], m["cfg"], torch.from_numpy(m["prompts"]), GEN,
                                     policy=tpol, compute_dtype=torch.float32,
                                     programmed=m["progs"][kind], collect_logits=True)
    assert tokens.dtype == torch.int32 and tokens.shape == (2, GEN + 1)
    assert np.array_equal(tokens.numpy(), want), (tokens.tolist(), want.tolist())
    check_class(kind, logits[:, 0].numpy(), first)


def test_greedy_sampled_matches_reference(model):
    """Every row draws token i with ``fold_in(PRNGKey(seed), i)``."""
    m = model
    knobs = dict(temperature=0.8, top_k=50, top_p=0.95, seed=3)
    want = np.asarray(j_greedy_generate(m["jparams"], m["jcfg"], jnp.asarray(m["prompts"]), GEN,
                                        compute_dtype=jnp.float32,
                                        sampling=JSamplingParams(**knobs)))
    got = greedy_generate(m["params"], m["cfg"], torch.from_numpy(m["prompts"]), GEN,
                          compute_dtype=torch.float32, sampling=SamplingParams(**knobs))
    assert np.array_equal(got.numpy(), want)


def test_reference_compiled_programming_departs_from_its_eager_programming(model):
    """Pinned gap (ROADMAP §C): the reference programs under ``jit``
    (``program_params``), and XLA evaluates the noise round trip (log,
    exp, the conductance-to-slice map) otherwise than the reference's own
    eager ``prepare_weight``: some noisy slice values move by a few ulps
    of a conductance.  The port's programming is the eager one bit for
    bit."""
    jpol, tpol = policies("mem_faithful")
    w = np.asarray(model["jparams"]["blocks"]["seg0"]["attn"]["q_proj"]["w"][0])
    key = jax.random.PRNGKey(5)
    eager = np.asarray(jdpe.prepare_weight(jnp.asarray(w), jpol.default, key).slices)
    compiled = np.asarray(jax.jit(lambda a, k: jdpe.prepare_weight(a, jpol.default, k).slices)(
        jnp.asarray(w), key))
    port = tdpe.prepare_weight(torch.from_numpy(w.copy()), tpol.default, prng.PRNGKey(5))
    off = float(np.mean(compiled != eager))
    print(f"compiled vs eager reference programming: {off:.2%} of the slice values differ")
    assert np.array_equal(port.slices.numpy(), eager)
    assert 0 < off < 0.5
    assert np.abs(compiled - eager).max() <= 1e-5 * np.abs(eager).max()
