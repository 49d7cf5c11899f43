"""The port's Mamba block (the second half of ``models/ssm.py``) against
the JAX reference, on the CPU.

jamba-smoke's Mamba widths (d_model 128, d_inner 256, dt_rank 8, d_state
8, conv 4), inputs from a numpy seed, float32.  The reference's block runs
under ``jax.jit``, as its serving steps do (``unroll`` 1 below 64 tokens,
8 from 64 on).  Classes:

* ``init_mamba_params``: bitwise (threefry key tree and draws, XLA's
  ``log`` of ``a``);
* ``_causal_conv``: bitwise against the eager reference, with and without
  a cache; within max rel 1e-6 of the jitted one (XLA fuses each tap's
  product into the add, measured 7.4e-8);
* ``mamba_block`` digital at 16 and 72 tokens: the output and the state
  ``h`` within max rel 1e-5 (measured <= 6e-7), the conv window within
  1e-6;
* ``mamba_decode`` for 4 steps after an 8-token block: each step's
  output within max rel 1e-5 of the reference's, and the port's steps
  within 1e-5 of its own 12-token block;
* a faithful block (int8 x int8, 32x32 arrays, ``dynamic_row``) on one
  programmed state, the port's, carried across: rel-Fro <= 1e-3 (the
  engine turns last-bit input differences into whole int8 codes);
* the programming keys of a hybrid group: every Mamba layer of a group
  takes the group's key and the name ``L.ssm.*`` (no layer index), so two
  layers with one weight are programmed bit for bit alike; the key's bits
  and one programmed projection equal the reference's.
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
from repro.core.layers import layer_key as j_layer_key
from repro.models import ssm as jssm
from repro_torch.configs import get, get_smoke
from repro_torch.core import DPEConfig, MemPolicy, spec
from repro_torch.core import dpe as tdpe
from repro_torch.core.layers import layer_key
from repro_torch.core.prng import PRNGKey, fold_in
from repro_torch.models import programmed as tprogrammed
from repro_torch.models import ssm as tssm
from repro_torch.models.common import layer_slice, tree_leaves

torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"
DIGITAL = (JMemPolicy(default=None), MemPolicy(default=None))
_KW = dict(array_size=(32, 32), mode="faithful", adc_mode="dynamic_row", backend="auto")
FAITHFUL = (JMemPolicy(default=JDPEConfig(input_spec=jspec("int8"), weight_spec=jspec("int8"),
                                          **_KW)),
            MemPolicy(default=DPEConfig(input_spec=spec("int8"), weight_spec=spec("int8"),
                                        **_KW)))
_MAMBA_PROJ = (("in_proj", "in"), ("in_proj_z", "z"), ("x_proj", "xp"), ("dt_proj", "dt"),
               ("out_proj", "out"))


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def block():
    jcfg, cfg = j_get_smoke(ARCH), get_smoke(ARCH)
    return dict(jcfg=jcfg, cfg=cfg, jp=jssm.init_mamba_params(jax.random.PRNGKey(3), jcfg),
                p=tssm.init_mamba_params(PRNGKey(3), cfg, device="cpu"))


def j_block(jcfg, policy, prepared=None, jit=True):
    def f(p, x, state, conv):
        return jssm.mamba_block(p, x, jcfg, policy=policy, rng=jax.random.PRNGKey(0),
                                name="L.ssm", state=state, conv_cache=conv, prepared=prepared)

    return jax.jit(f) if jit else f


@pytest.mark.parametrize("seed", [0, 3])
def test_init_mamba_params_bitwise(seed):
    jcfg, cfg = j_get_smoke(ARCH), get_smoke(ARCH)
    want = jssm.init_mamba_params(jax.random.PRNGKey(seed), jcfg)
    got = tssm.init_mamba_params(PRNGKey(seed), cfg, device="cpu")
    wl, gl = jax.tree_util.tree_leaves(want), tree_leaves(got)
    assert len(wl) == len(gl) == 10
    for a, b in zip(wl, gl):
        assert b.dtype == torch.float32 and np.array_equal(np.asarray(a), b.numpy())
    assert tssm._mamba_dims(get(ARCH)) == jssm._mamba_dims(j_get(ARCH)) == (8192, 256, 16, 4)
    assert tssm._mamba_dims(cfg) == jssm._mamba_dims(jcfg) == (256, 8, 8, 4)


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv(block, with_cache):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 256)).astype(np.float32)
    b = rng.standard_normal(256).astype(np.float32)
    cache = rng.standard_normal((2, 3, 256)).astype(np.float32) if with_cache else None
    w = np.asarray(block["jp"]["conv"]["w"])
    jargs = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
             None if cache is None else jnp.asarray(cache))
    out, win = tssm._causal_conv(t(x), t(w), t(b), None if cache is None else t(cache))
    eager, eager_win = jssm._causal_conv(*jargs)
    assert np.array_equal(out.numpy(), np.asarray(eager))
    assert np.array_equal(win.numpy(), np.asarray(eager_win))
    jitted, _ = jax.jit(jssm._causal_conv)(*jargs)
    assert rel_max(out.numpy(), jitted) <= 1e-6
    assert win.shape == (2, 3, 256)


@pytest.mark.parametrize("s", [16, 72])
def test_mamba_block_digital(block, s):
    x = (np.random.default_rng(s).standard_normal((2, s, 128)) * 0.5).astype(np.float32)
    jy, (jh, jconv) = j_block(block["jcfg"], DIGITAL[0])(block["jp"], jnp.asarray(x), None, None)
    y, (h, conv) = tssm.mamba_block(block["p"], t(x), block["cfg"], policy=DIGITAL[1],
                                    rng=PRNGKey(0), name="L.ssm")
    assert h.dtype == torch.float32 and h.shape == (2, 256, 8) and conv.shape == (2, 3, 256)
    assert rel_max(y.numpy(), jy) <= 1e-5
    assert rel_max(h.numpy(), jh) <= 1e-5
    assert rel_max(conv.numpy(), jconv) <= 1e-6


def test_mamba_decode_steps(block):
    cfg, jcfg, p, jp = block["cfg"], block["jcfg"], block["p"], block["jp"]
    x = (np.random.default_rng(5).standard_normal((2, 12, 128)) * 0.5).astype(np.float32)
    jdec = jax.jit(lambda p, x1, h, c: jssm.mamba_decode(
        p, x1, jcfg, policy=DIGITAL[0], rng=jax.random.PRNGKey(0), name="L.ssm", state=h,
        conv_cache=c))
    _, (jh, jc) = j_block(jcfg, DIGITAL[0])(jp, jnp.asarray(x[:, :8]), None, None)
    kw = dict(policy=DIGITAL[1], rng=PRNGKey(0), name="L.ssm")
    _, (h, c) = tssm.mamba_block(p, t(x[:, :8]), cfg, **kw)
    whole, _ = tssm.mamba_block(p, t(x), cfg, **kw)
    for i in range(8, 12):
        jy, jh, jc = jdec(jp, jnp.asarray(x[:, i]), jh, jc)
        y, h, c = tssm.mamba_decode(p, t(x[:, i]), cfg, state=h, conv_cache=c, **kw)
        assert y.shape == (2, 128) and c.shape == (2, 3, 256)
        assert rel_max(y.numpy(), jy) <= 1e-5, i
        assert rel_max(h.numpy(), jh) <= 1e-5, i
        assert rel_max(y.numpy(), whole[:, i].numpy()) <= 1e-5, i


def _programmed(p, pol, rng):
    """The port's programmed Mamba projections, named as in a group."""
    cfg = pol.default
    return {pk: tdpe.program_weight(p[pk]["w"], cfg, layer_key(rng, f"L.ssm.{sfx}"))
            for pk, sfx in _MAMBA_PROJ}


def test_faithful_block_one_programmed_state(block):
    x = (np.random.default_rng(9).standard_normal((2, 6, 128)) * 0.5).astype(np.float32)
    prog = _programmed(block["p"], FAITHFUL[1], PRNGKey(0))
    jprog = {k: jdpe.PreparedWeight(jnp.asarray(v.slices.numpy()), jnp.asarray(v.scale.numpy()))
             for k, v in prog.items()}
    jy, (jh, _) = j_block(block["jcfg"], FAITHFUL[0], jprog)(block["jp"], jnp.asarray(x), None,
                                                            None)
    y, (h, _) = tssm.mamba_block(block["p"], t(x), block["cfg"], policy=FAITHFUL[1],
                                 rng=PRNGKey(0), name="L.ssm", prepared=prog)
    assert np.isfinite(y.numpy()).all()
    assert rel_fro(y.numpy(), jy) <= 1e-3
    assert rel_fro(h.numpy(), jh) <= 1e-3


def test_group_shares_programming_key():
    """jamba-smoke's first group, programmed faithful: its Mamba layers
    (in-group 0-3, 5-7) all take ``fold_in(fold_in(rng, 0), 0)`` and the
    name ``L.ssm.*``; with layer 2's weights set to layer 0's, the two are
    programmed alike, bit for bit."""
    from repro_torch.models import init_params

    cfg = get_smoke(ARCH).replace(hybrid_moe_idx=())
    params = init_params(cfg, 0, device="cpu")
    group = layer_slice(params["blocks"]["seg0"], 0)
    group["l2"]["ssm"] = group["l0"]["ssm"]
    rng = fold_in(fold_in(PRNGKey(0), 0), 0)
    one = tprogrammed._prog_block(group, cfg, 0, rng, FAITHFUL[1], 0.0, True)
    for pk, _ in _MAMBA_PROJ:
        a, b = one["l0"]["ssm"][pk], one["l2"]["ssm"][pk]
        assert torch.equal(a.slices, b.slices) and torch.equal(a.scale, b.scale), pk
        assert not torch.equal(a.slices, one["l1"]["ssm"][pk].slices), pk
    assert sorted(one["l4"]) == ["attn", "mlp"]
    # the key and one programmed projection against the reference's
    jrng = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 0), 0)
    for _, sfx in _MAMBA_PROJ:
        assert np.array_equal(layer_key(rng, f"L.ssm.{sfx}"),
                              np.asarray(j_layer_key(jrng, f"L.ssm.{sfx}"))), sfx
    w = group["l0"]["ssm"]["x_proj"]["w"]
    jw = jdpe.program_weight(jnp.asarray(w.numpy()), FAITHFUL[0].default,
                             j_layer_key(jrng, "L.ssm.xp"), 0.0)
    got = one["l0"]["ssm"]["x_proj"]
    assert np.array_equal(got.slices.numpy(), np.asarray(jw.slices))
    assert np.array_equal(got.scale.numpy(), np.asarray(jw.scale))
