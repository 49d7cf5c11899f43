"""The port's jamba-smoke served faithfully against the JAX reference, on
the CPU (the digital classes are ``test_torch_hybrid_serve.py``'s).

jamba-smoke (one period: Mamba layers, attention at in-group index 4,
MoE over 4 experts top 2 on the odd indices), the port's ``init_params``
(the reference's draws bit for bit, ``test_torch_hybrid_serve.py``) on
both sides, batch 1, prompt 4, one new token, float32, under int8 x int8
on 32x32
arrays, ``dynamic_row`` ADC, backend ``auto``, the router digital.  Both
sides serve ONE programmed state, the port's (the reference's compiled
programming departs from its eager one, ROADMAP §C); the reference's
prefill and decode steps run under ``jax.jit``, as its
``greedy_generate`` runs them.  Class: tokens equal, every logit row
within rel-Fro 2e-2 (the engine turns last-bit differences of the
digital parts, the Mamba scan's and conv's fused multiply-adds among
them, into whole int8 input codes; measured <= 1.6e-3).  The plain K1
rounds every fused multiply-add once (``core/xmath.fma``), ~4.5 s a
jamba-smoke step on the CPU, so this file serves one new token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import DPEConfig as JDPEConfig
from repro.core import dpe as jdpe
from repro.core import spec as jspec
from repro.core.layers import MemPolicy as JMemPolicy
from repro.serve.engine import make_decode_step as j_make_decode_step
from repro.serve.engine import make_prefill_step as j_make_prefill_step
from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec
from repro_torch.models import init_params, program_params
from repro_torch.serve import greedy_generate

torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"
GEN = 1
LOGIT_CLASS = 2e-2  # rel-Fro a logit row


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def to_reference(tree):
    """The port's programmed state as the reference's (untimed) tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_reference(v) for k, v in tree.items()}
    return jdpe.PreparedWeight(jnp.asarray(tree.slices.numpy()), jnp.asarray(tree.scale.numpy()))


def test_faithful_greedy_matches_reference():
    kw = dict(array_size=(32, 32), mode="faithful", adc_mode="dynamic_row", backend="auto")
    jpol = JMemPolicy(default=JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"),
                                         **kw), overrides=(("router", None),))
    tpol = MemPolicy(default=DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"), **kw),
                     overrides=(("router", None),))
    jcfg, cfg = j_get_smoke(ARCH), get_smoke(ARCH)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (1, 4)).astype(np.int32)
    params = init_params(cfg, 0, device="cpu")
    prog = program_params(params, cfg, tpol)
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    jprog = to_reference(prog)
    # the reference's greedy_generate, its logits kept
    prefill = jax.jit(j_make_prefill_step(jcfg, jpol, max_len=4 + GEN + 1,
                                          compute_dtype=jnp.float32, cache_dtype=jnp.float32))
    decode = jax.jit(j_make_decode_step(jcfg, jpol, compute_dtype=jnp.float32))
    logits, cache = prefill(jparams, {"tokens": jnp.asarray(prompts)}, jprog)
    rows, want = [logits], [jnp.argmax(logits, axis=-1)]
    for _ in range(GEN):
        logits, cache = decode(jparams, cache, want[-1], jprog)
        rows.append(logits)
        want.append(jnp.argmax(logits, axis=-1))
    tokens, got = greedy_generate(params, cfg, torch.from_numpy(prompts), GEN, policy=tpol,
                                  compute_dtype=torch.float32, programmed=prog,
                                  collect_logits=True)
    want = np.stack([np.asarray(w) for w in want], axis=1)
    assert np.array_equal(tokens.numpy(), want), (tokens.tolist(), want.tolist())
    assert np.isfinite(got.numpy()).all()
    for i, row in enumerate(rows):
        for b in range(1):
            assert rel_fro(got[b, i].numpy(), row[b]) <= LOGIT_CLASS, (b, i)
