"""The dense serving path's own contracts, and the meaning of
``backend="auto"`` past 128 rows against the reference's kernel.

qwen2-smoke, float32, the port alone unless a test says otherwise:

* ``greedy_generate`` with ``weight_stationary=False`` (programming
  every call on the fly from the same per-layer keys) equals the
  programmed run bit for bit, tokens and logits;
* sampling at temperature 0 equals the greedy run bit for bit;
* the ``ServeLoop`` (paged cache, K2 / K3's plain versions) emits per
  request the tokens of ``greedy_generate`` on that prompt alone (dense
  cache, einsum attention), the logits within max rel 1e-5 (digital,
  fast) and rel-Fro 1e-3 (faithful ``dynamic_row``): the two attentions
  sum in other orders, so the class is token-equal, not bitwise;
* inactive rows of a dense decode step keep their ``pos`` and cache;
* ``make_policy("mem_faithful")`` on 136 rows in one call: the port's
  ``auto`` ranges the ``dynamic`` ADC over 128-row tiles, the reference's
  Pallas kernel's (``set_interpret(True)``), not over the whole call as
  the reference's CPU engine does (ROADMAP §C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import dpe as jdpe
from repro.kernels import ops as j_ops
from repro.launch.dryrun import make_policy as j_make_policy
from repro.models import init_params as j_init_params
from repro.models.model import forward as j_forward
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec
from repro_torch.launch.dryrun import make_policy
from repro_torch.models import decode_step, forward, init_cache, init_params, program_params
from repro_torch.serve import Request, SamplingParams, ServeConfig, ServeLoop, greedy_generate

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def serving_policy(kind):
    """``test_torch_serve.py``'s classes; ``mem_fast`` keeps
    ``make_policy``'s bf16 store (no reference involved)."""
    if kind == "digital":
        return MemPolicy(default=None)
    if kind == "mem_fast":
        return make_policy("mem_fast")
    return MemPolicy(default=DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"),
                                       array_size=(32, 32), adc_mode="dynamic_row",
                                       backend="auto"))


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke("qwen2-0.5b")
    return cfg, init_params(cfg, 0, device="cpu")


def test_greedy_weight_stationary_equals_per_call(model):
    """``make_policy("mem_faithful")``: one prompt of 4 tokens, 1 new."""
    cfg, params = model
    pol = make_policy("mem_faithful")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, 4)))

    def run(**kw):
        return greedy_generate(params, cfg, prompt, 1, policy=pol, compute_dtype=torch.float32,
                               collect_logits=True, **kw)

    a, la = run()
    b, lb = run(weight_stationary=False)
    assert torch.equal(a, b) and torch.equal(la, lb)


def test_greedy_temperature_zero_is_the_greedy_run(model):
    cfg, params = model
    pol = serving_policy("mem_fast")
    prompts = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)))
    prog = program_params(params, cfg, pol)

    def run(**kw):
        return greedy_generate(params, cfg, prompts, 4, policy=pol, compute_dtype=torch.float32,
                               programmed=prog, collect_logits=True, **kw)

    a, la = run()
    b, lb = run(sampling=SamplingParams(temperature=0.0, seed=5))
    assert torch.equal(a, b) and torch.equal(la, lb)


@pytest.mark.parametrize("kind", ["digital", "mem_fast", "mem_faithful"])
def test_serveloop_equals_solo_greedy_generate(model, kind):
    """Three prompts (11, 5 and 7 tokens, 3 new each) through a 2-slot
    ``ServeLoop`` (prefill chunk 8, block size 8, one lane refilled)."""
    cfg, params = model
    pol = serving_policy(kind)
    prog = program_params(params, cfg, pol)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (11, 5, 7)]
    loop = ServeLoop(params, cfg, ServeConfig(
        policy=pol, slots=2, max_len=32, prefill_chunk=8, block_size=8,
        compute_dtype=torch.float32, device="cpu", collect_logits=True), programmed=prog)
    rep = loop.run([Request(i, p, 3) for i, p in enumerate(prompts)])
    for res, p in zip(rep.results, prompts):
        tokens, logits = greedy_generate(params, cfg, torch.from_numpy(p)[None], 2, policy=pol,
                                         compute_dtype=torch.float32, programmed=prog,
                                         collect_logits=True)
        assert res.tokens == tokens[0].tolist()
        got, want = logits[0].numpy(), np.stack(res.logits)
        assert got.shape == want.shape and np.isfinite(got).all()
        if kind == "mem_faithful":
            assert rel_fro(got, want) <= 1e-3
        else:
            assert rel_max(got, want) <= 1e-5


def test_dense_decode_inactive_rows_keep_their_cache(model):
    """``active`` False on a row: its ``pos`` and cache rows stay as they
    were; the active row writes its token's K / V at its ``pos``."""
    cfg, params = model
    cache = init_cache(cfg, 2, 6, dtype=torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    for seg in cache["blocks"].values():
        for t in seg.values():
            t.copy_(torch.randn(t.shape, generator=g))
    cache["pos"] = torch.tensor([2, 4], dtype=torch.int32)
    before = {k: t.clone() for k, t in cache["blocks"]["seg0"].items()}
    logits, cache = decode_step(params, cfg, cache, torch.tensor([7, 9]),
                                compute_dtype=torch.float32, active=torch.tensor([True, False]))
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all()
    assert cache["pos"].tolist() == [3, 4]
    for k, t in cache["blocks"]["seg0"].items():
        assert torch.equal(t[:, 1], before[k][:, 1])
        assert torch.equal(t[:, 0, :2], before[k][:, 0, :2])
        assert torch.equal(t[:, 0, 3:], before[k][:, 0, 3:])
        assert not torch.equal(t[:, 0, 2], before[k][:, 0, 2])


def test_forward_dynamic_adc_over_128_rows_is_the_reference_kernels(model):
    """One prompt of 136 tokens through qwen2-smoke with
    ``make_policy("mem_faithful")`` (``dynamic`` ADC, 128x128 arrays): 136
    rows in each projection.  Against the reference with its Pallas
    kernel (``set_interpret(True)``, where ``auto`` resolves to it, with
    128-row tiles) the hidden states and K / V hold the faithful class,
    rel-Fro <= 1e-3 (the kernel and the port's K1 sum a slice pair in
    other orders: the pinned gap of ROADMAP §C); against the reference's
    CPU engine, whose range spans all 136 rows, they part by more than
    that.  Both sides serve the port's programmed state."""
    cfg, params = model
    jcfg = j_get_smoke("qwen2-0.5b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    pol, jpol = make_policy("mem_faithful"), j_make_policy("mem_faithful")
    prog = program_params(params, cfg, pol)

    def to_ref(tree):
        if isinstance(tree, dict):
            return {k: to_ref(v) for k, v in tree.items()}
        return jdpe.PreparedWeight(jnp.asarray(tree.slices.numpy()), jnp.asarray(tree.scale.numpy()))

    jprog = to_ref(prog)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (1, 136)).astype(np.int32)

    def reference():
        return jax.jit(lambda p, b, pr: j_forward(
            p, jcfg, b, policy=jpol, rng=jax.random.PRNGKey(0), mode="prefill",
            compute_dtype=jnp.float32, programmed=pr))(
            jparams, {"tokens": jnp.asarray(prompts)}, jprog)

    prev = j_ops.set_interpret(True)
    try:
        jh_kernel, jst_kernel = reference()
    finally:
        j_ops.set_interpret(prev)
    jh_cpu, _ = reference()
    h, st = forward(params, cfg, {"tokens": torch.from_numpy(prompts)}, policy=pol,
                    mode="prefill", compute_dtype=torch.float32, programmed=prog)
    to_kernel = max(rel_fro(h.numpy(), jh_kernel),
                    rel_fro(st["seg0"]["k"].numpy(), jst_kernel["seg0"]["k"]),
                    rel_fro(st["seg0"]["v"].numpy(), jst_kernel["seg0"]["v"]))
    to_cpu = rel_fro(h.numpy(), jh_cpu)
    print(f"136 rows: port vs reference kernel {to_kernel:.2e}, vs reference CPU engine "
          f"{to_cpu:.2e}")
    assert to_kernel <= 1e-3
    assert to_cpu > 10 * to_kernel
