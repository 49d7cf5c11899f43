"""The port's rwkv6 model and its dense serving path against the JAX
reference, and the path's own contracts.

rwkv6-smoke (2 layers, d_model 128, 4 heads of 32, vocab 512) with the
reference's weights (``init_params`` draws them bit for bit), batch 2,
prompt 8, float32.  The hardware policies are ``test_torch_dense.py``'s
(int8, 32x32 arrays, ``dynamic_row`` ADC, float32 store), and both sides
serve ONE programmed state, the port's (the reference's compiled
programming departs from its eager one, ROADMAP §C).  Classes:

* ``forward`` in prefill mode under ``DIGITAL``: hidden states max rel
  <= 1e-5, the states ``s`` and ``x_prev`` <= 1e-5; a decode step from
  each side's prefill cache, logits max rel <= 1e-5;
* ``greedy_generate`` (4 new tokens): tokens equal for digital,
  ``mem_fast`` and ``mem_faithful``; the first-token logits max rel
  <= 1e-5 (digital), rel-Fro <= 2e-2 (fast) and 1e-3 (faithful): the
  digital parts are not bitwise, and the engines turn last-bit
  differences of their inputs into whole int8 codes (``LOGIT_CLASS``);
* the full ``CONFIG``: dims and ``param_count`` equal the reference's;
* the launcher, ``--arch rwkv6-1.6b --smoke`` (digital): tokens equal
  the reference launcher's.

The port's own contracts (no reference involved):

* programmed equals per-call programming, bitwise (tokens and logits);
* an 80-token prefill (the chunked form) then decoding equals 80 decode
  steps (the scan) then decoding: tokens equal, logits max rel <= 1e-4;
* rows where ``active`` is False keep ``s``, ``x_prev`` and ``pos`` bit
  for bit, and the active rows are the unmasked step's;
* the ``ServeLoop``, ``init_paged_cache``, ``block_chunk`` and
  ``block_verify`` refuse rwkv6 as the reference's do; Mamba, MoE and
  hybrid layers are refused;
* the trainer (``loss_fn`` and ``python -m repro_torch.launch.train``)
  refuses rwkv6: its gradients are not ported yet.
"""
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
from repro.models import transformer as jtransformer
from repro.models.model import decode_step as j_decode_step
from repro.models.model import forward as j_forward
from repro.models.model import init_paged_cache as j_init_paged_cache
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeLoop as JServeLoop
from repro.serve import greedy_generate as j_greedy_generate
from repro.serve.engine import make_prefill_step as j_make_prefill_step
from repro_torch.configs import get, get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec
from repro_torch.core import dpe as tdpe
from repro_torch.launch import serve, train
from repro_torch.models import (
    decode_step,
    forward,
    init_cache,
    init_paged_cache,
    init_params,
    loss_fn,
    program_params,
)
from repro_torch.models import transformer as ttransformer
from repro_torch.models.config import MoEConfig, SSMConfig
from repro_torch.models.common import layer_slice
from repro_torch.serve import ServeConfig, ServeLoop, greedy_generate
from repro_torch.serve.engine import make_prefill_step

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

KINDS = ["digital", "mem_fast", "mem_faithful"]
GEN = 4
# first-token logits, rel-Fro: the engines quantise every input per
# 32-wide block, so the digital parts' last-bit differences (the mix's
# and the norms' fused multiply-adds, the einsums' orders) move whole
# input codes; under mem_fast one such code of the first layer's MLP
# input gives 1.2e-2 on row 1 (row 0 within 1e-6)
LOGIT_CLASS = {"mem_fast": 2e-2, "mem_faithful": 1e-3}


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def policies(kind):
    """(reference, port) policy of ``test_torch_dense.py``'s classes."""
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
        return jdpe.PreparedWeight(jnp.asarray(tree.slices.numpy()),
                                   jnp.asarray(tree.scale.numpy()))
    return jdpe.FoldedWeight(jnp.asarray(tree.w_eff.numpy()))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = j_get_smoke("rwkv6-1.6b"), get_smoke("rwkv6-1.6b")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    params = init_params(cfg, 0, device="cpu")
    progs = {kind: program_params(params, cfg, policies(kind)[1]) for kind in KINDS}
    return dict(jcfg=jcfg, jparams=j_init_params(jcfg, jax.random.PRNGKey(0)), cfg=cfg,
                params=params, prompts=prompts, progs=progs,
                jprogs={k: to_reference(v) for k, v in progs.items()})


def test_programmed_tree_names_the_ssm_projections(model):
    """``_prog_layer`` names the layer ``L.ssm``: its projections'
    programming-noise keys are the forward's (per-call equality below),
    and the tree mirrors the params (``ssm`` and ``mlp``)."""
    prog = model["progs"]["mem_faithful"]["blocks"]["seg0"]
    assert sorted(prog) == ["mlp", "ssm"]
    assert sorted(prog["ssm"]) == ["g_proj", "k_proj_ssm", "r_proj", "v_proj_ssm", "wkv_out"]
    assert prog["ssm"]["r_proj"].slices.shape[0] == model["cfg"].n_layers


def test_forward_prefill_and_decode_step_match_reference(model):
    m = model
    batch = {"tokens": jnp.asarray(m["prompts"])}
    jh, jst = jax.jit(lambda p, b: j_forward(p, m["jcfg"], b, mode="prefill",
                                             compute_dtype=jnp.float32))(m["jparams"], batch)
    h, st = forward(m["params"], m["cfg"], {"tokens": torch.from_numpy(m["prompts"])},
                    mode="prefill", compute_dtype=torch.float32)
    assert sorted(st["seg0"]) == ["s", "x_prev"]
    assert rel_max(h.numpy(), jh) <= 1e-5
    for k in ("s", "x_prev"):
        assert st["seg0"][k].shape == jst["seg0"][k].shape
        assert rel_max(st["seg0"][k].numpy(), jst["seg0"][k]) <= 1e-5
    # one decode step from each side's own prefill cache
    jpol, tpol = policies("digital")
    _, jcache = jax.jit(j_make_prefill_step(m["jcfg"], jpol, compute_dtype=jnp.float32,
                                            cache_dtype=jnp.float32))(m["jparams"], batch)
    tok = np.array([3, 77], np.int32)
    jlogits, _ = jax.jit(lambda p, c, t: j_decode_step(p, m["jcfg"], c, t, policy=jpol,
                                                       compute_dtype=jnp.float32))(
        m["jparams"], jcache, jnp.asarray(tok))
    _, cache = make_prefill_step(m["cfg"], tpol, compute_dtype=torch.float32,
                                 cache_dtype=torch.float32)(
        m["params"], {"tokens": torch.from_numpy(m["prompts"])})
    assert cache["blocks"]["seg0"]["s"].dtype == torch.float32
    logits, cache = decode_step(m["params"], m["cfg"], cache, torch.from_numpy(tok),
                                compute_dtype=torch.float32)
    assert cache["pos"].tolist() == [9, 9]
    assert rel_max(logits.numpy(), jlogits) <= 1e-5


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
    got = logits[:, 0].numpy()
    assert np.isfinite(got).all()
    if kind == "digital":
        assert rel_max(got, first) <= 1e-5
    else:
        assert rel_fro(got, first) <= LOGIT_CLASS[kind]


def test_full_config_matches_reference():
    cfg, jcfg = get("rwkv6-1.6b"), j_get("rwkv6-1.6b")
    for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "head_dim", "norm", "act", "rope_theta"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.ssm.kind, cfg.ssm.head_dim) == (jcfg.ssm.kind, jcfg.ssm.head_dim) == ("rwkv6", 64)
    assert cfg.param_count() == jcfg.param_count()
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab) == (24, 2048, 7168, 65536)
    assert get_smoke("rwkv6-1.6b") == get_smoke("rwkv6_1p6b")


def test_launcher_matches_reference(capsys):
    args = ["--arch", "rwkv6-1.6b", "--smoke", "--batch", "2", "--prompt_len", "8", "--gen", "4"]
    want = np.asarray(j_serve.main(args))
    capsys.readouterr()
    got = serve.main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert got.shape == (2, 5) and np.array_equal(got.numpy(), want), (got.tolist(), want)
    assert "generated (2, 5) tokens in" in out
    with pytest.raises(NotImplementedError, match="all-attention"):
        serve.main(args + ["--device", "cpu", "--requests", "2"])


def test_programmed_equals_per_call(model):
    """``make_policy``-like faithful policy: one prompt of 4 tokens, 2 new,
    programmed once or on every call from the same keys."""
    m = model
    _, pol = policies("mem_faithful")
    prompt = torch.from_numpy(m["prompts"][:1, :4])

    def run(**kw):
        return greedy_generate(m["params"], m["cfg"], prompt, 2, policy=pol,
                               compute_dtype=torch.float32, collect_logits=True, **kw)

    a, la = run(programmed=m["progs"]["mem_faithful"])
    b, lb = run(weight_stationary=False)
    assert torch.equal(a, b) and torch.equal(la, lb)


def test_prefill_then_decode_equals_decoding_every_token(model):
    """An 80-token prompt (three chunks of the chunked form, the last
    padded) against the same prompt fed token by token (the scan)."""
    m = model
    cfg, params = m["cfg"], m["params"]
    prompt = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (2, 80)))
    tokens, logits = greedy_generate(params, cfg, prompt, 3, compute_dtype=torch.float32,
                                     collect_logits=True)
    cache = init_cache(cfg, 2, 1, dtype=torch.float32, device="cpu")
    for i in range(80):
        step, cache = decode_step(params, cfg, cache, prompt[:, i], compute_dtype=torch.float32)
    rows, out = [step], [torch.argmax(step, dim=-1)]
    for _ in range(3):
        step, cache = decode_step(params, cfg, cache, out[-1], compute_dtype=torch.float32)
        rows.append(step)
        out.append(torch.argmax(step, dim=-1))
    assert torch.equal(tokens, torch.stack(out, 1).to(torch.int32))
    assert cache["pos"].tolist() == [83, 83]
    assert rel_max(logits.numpy(), torch.stack(rows, 1).numpy()) <= 1e-4


def test_inactive_rows_keep_their_state(model):
    m = model
    cfg, params = m["cfg"], m["params"]
    _, cache = make_prefill_step(cfg, None, compute_dtype=torch.float32,
                                 cache_dtype=torch.float32)(
        params, {"tokens": torch.from_numpy(m["prompts"])})
    clone = lambda c: {"pos": c["pos"].clone(), "blocks": {  # noqa: E731
        s: {k: v.clone() for k, v in seg.items()} for s, seg in c["blocks"].items()}}
    before, free = clone(cache), clone(cache)
    tok = torch.tensor([5, 6])
    want, free = decode_step(params, cfg, free, tok, compute_dtype=torch.float32)
    got, cache = decode_step(params, cfg, cache, tok, compute_dtype=torch.float32,
                             active=torch.tensor([True, False]))
    assert cache["pos"].tolist() == [9, 8]
    assert torch.equal(got[0], want[0])
    for k in ("s", "x_prev"):
        new, old, ref = (c["blocks"]["seg0"][k] for c in (cache, before, free))
        assert torch.equal(new[:, 1], old[:, 1]), k
        assert torch.equal(new[:, 0], ref[:, 0]) and not torch.equal(new[:, 0], old[:, 0]), k


def test_recurrent_serving_refusals_match_reference(model):
    m = model
    cfg, jcfg = m["cfg"], m["jcfg"]
    with pytest.raises(NotImplementedError, match="all-attention"):
        ServeLoop(m["params"], cfg, ServeConfig(device="cpu"))
    with pytest.raises(NotImplementedError, match="all-attention"):
        JServeLoop(m["jparams"], jcfg, JServeConfig())
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


def test_unported_layer_kinds_raise(model):
    cfg, qcfg = model["cfg"], get_smoke("qwen2-0.5b")
    for bad in (cfg.replace(ssm=SSMConfig(kind="mamba")),
                qcfg.replace(moe=MoEConfig(n_experts=4, top_k=2, d_expert=64)),
                qcfg.replace(family="hybrid", hybrid_period=2, hybrid_attn_idx=(0,),
                             ssm=SSMConfig(kind="mamba"))):
        with pytest.raises(NotImplementedError, match="not ported"):
            init_params(bad, 0, device="cpu")


@pytest.mark.parametrize("entry", ["loss_fn", "launch.train"])
def test_trainer_refuses_rwkv6(model, entry):
    """Training rwkv6 is not ported (no gradient of the WKV forms is held
    against the reference's): the loss and the train launcher refuse it."""
    with pytest.raises(NotImplementedError, match="training ssm layers"):
        if entry == "loss_fn":
            toks = torch.from_numpy(model["prompts"]).long()
            loss_fn(model["params"], model["cfg"], {"tokens": toks, "labels": toks},
                    compute_dtype=torch.float32)
        else:
            train.main(["--arch", "rwkv6-1.6b", "--smoke", "--steps", "1", "--batch", "2",
                        "--seq", "16", "--device", "cpu"])
