"""The port's RWKV6 time-mix (``repro_torch.models.ssm``) against the JAX
reference's (``repro.models.ssm``), on the same numpy inputs.

rwkv6-smoke (2 layers, d_model 128, 4 heads of 32), float32, the
reference jitted as its model runs it.  Classes (max rel: the largest
difference over the largest value):

* ``init_params``: bitwise, leaf by leaf;
* XLA's CPU ``tanh``, ``silu`` and subnormal flush: bitwise over 10**6
  inputs (``xmath.tanh``, ``ssm._silu``, ``xmath.ftz``);
* ``_wkv_scan`` (S = 8) and ``_wkv_chunked`` (S = 64; S = 80 with a
  carried state and decays that underflow the 1e-37 clamp): max rel
  <= 1e-6 (the einsums and the fused multiply-adds XLA forms sum and
  round otherwise); the chunked form's state is bitwise where the decays
  stay normal;
* the chunked form computing its state-free terms in groups of 1 or 2
  chunks against all at once: bitwise;
* the two forms against each other inside the port: max rel <= 2e-6
  (the reference's own gap is 8.7e-7 at S = 80); with decays that
  underflow, <= 1e-4 (the reference's own gap is 5.6e-5: the chunked
  form's differences of log-decay sums near -85 per token cancel);
* ``rwkv6_block`` (S = 8, the scan; S = 80, the chunked form) and
  ``rwkv6_decode``: out max rel <= 1e-5, state <= 1e-6, ``x_last``
  bitwise;
* ``layer_norm`` (``norm(..., "ln")``, first used by rwkv6): max rel
  <= 1e-6 (XLA's ``rsqrt`` and summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core.layers import MemPolicy as JMemPolicy
from repro.models import common as jcommon
from repro.models import init_params as j_init_params
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke
from repro_torch.core import MemPolicy, xmath
from repro_torch.core.prng import PRNGKey
from repro_torch.models import common as tcommon
from repro_torch.models import init_params
from repro_torch.models import ssm as tssm
from repro_torch.models.common import layer_slice, tree_leaves

# the suite runs in several worker processes: one intra-op thread each
# keeps torch from oversubscribing the cores
torch.set_num_threads(1)

B, H, N = 2, 4, 32


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = j_get_smoke("rwkv6-1.6b"), get_smoke("rwkv6-1.6b")
    return dict(jcfg=jcfg, cfg=cfg, params=init_params(cfg, 0, device="cpu"),
                jparams=j_init_params(jcfg, jax.random.PRNGKey(0)))


def wkv_inputs(seed, s, w_lo=0.05, state=True):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((B, s, H, N)).astype(np.float32) for _ in range(3))
    w = rng.uniform(w_lo, 0.99, (B, s, H, N)).astype(np.float32)
    u = 0.5 * rng.standard_normal((H, N)).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((B, H, N, N)) if state
          else np.zeros((B, H, N, N))).astype(np.float32)
    return r, k, v, w, u, s0


def underflowing(w, seed):
    """Decays of which a quarter underflow the 1e-37 clamp: normal values
    below it, float32 subnormals and zeros."""
    rng = np.random.default_rng(seed)
    tiny = rng.choice(np.array([5e-38, 2e-38, 1e-39, 1e-44, 0.0], np.float32), w.shape)
    return np.where(rng.uniform(size=w.shape) < 0.25, tiny, w).astype(np.float32)


def test_init_params_bitwise_to_reference(model):
    got = tree_leaves(model["params"], paths=True)
    want = jax.tree_util.tree_flatten_with_path(model["jparams"])[0]
    assert [p for p, _ in got] == ["/".join(k.key for k in path) for path, _ in want]
    assert "blocks/seg0/ssm/w_lora_a" in dict(got)
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), np.asarray(b)), path


def _bits_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_tanh_is_xlas_bitwise():
    rng = np.random.default_rng(0)
    x = np.concatenate([3 * rng.standard_normal(400_000), rng.uniform(-12, 12, 300_000),
                        1e-3 * rng.standard_normal(200_000), rng.uniform(-4e-4, 4e-4, 100_000),
                        [0.0, -0.0, 7.99881172180175781, -8.0, 9.0, 0.0004, -0.0004]]
                       ).astype(np.float32)
    want = np.asarray(jax.jit(jnp.tanh)(x))
    assert _bits_equal(xmath.tanh(t(x)).numpy(), want)
    assert np.mean(torch.tanh(t(x)).numpy() != want) > 0.3  # why the replay


def test_silu_and_subnormal_flush_are_xlas_bitwise():
    """``jax.nn.silu`` is ``x * (1 / (1 + exp(-x)))`` under XLA, whose CPU
    code flushes float32 subnormals to zero: ``exp`` below -87.3 and the
    reciprocal of ``1 + exp(88)`` give 0 there, subnormals in torch."""
    rng = np.random.default_rng(1)
    x = np.concatenate([3 * rng.standard_normal(600_000), rng.uniform(-100, 100, 300_000),
                        rng.uniform(-89, -87, 50_000), rng.uniform(87, 89, 50_000)]
                       ).astype(np.float32)
    assert _bits_equal(tssm._silu(t(x)).numpy(), np.asarray(jax.jit(jax.nn.silu)(x)))
    want = np.asarray(jax.jit(jnp.exp)(-x))
    got = tssm._exp(-t(x)).numpy()
    assert _bits_equal(got, want)
    raw = xmath.exp(-t(x)).numpy()
    assert ((raw != 0) & (np.abs(raw) < np.finfo(np.float32).tiny)).any()  # what ftz removes
    assert _bits_equal(xmath.ftz(t(np.array([1e-39, -1e-39, 1e-38, 2e-38], np.float32))).numpy(),
                       np.array([0.0, -0.0, 0.0, 2e-38], np.float32))


def test_wkv_scan_matches_reference():
    args = wkv_inputs(0, 8)
    jo, js = jax.jit(jssm._wkv_scan)(*args)
    to, ts = tssm._wkv_scan(*map(t, args))
    assert rel_max(to.numpy(), jo) <= 1e-6
    assert rel_max(ts.numpy(), js) <= 1e-6


@pytest.mark.parametrize("s,underflow", [(64, False), (80, True)])
def test_wkv_chunked_matches_reference(s, underflow):
    r, k, v, w, u, s0 = wkv_inputs(1, s, state=underflow)
    if underflow:
        w = underflowing(w, 2)
    jo, js = jax.jit(jssm._wkv_chunked)(r, k, v, w, u, s0)
    to, ts = tssm._wkv_chunked(*map(t, (r, k, v, w, u, s0)))
    assert np.isfinite(to.numpy()).all() and np.isfinite(ts.numpy()).all()
    assert rel_max(to.numpy(), jo) <= 1e-6
    if underflow:
        assert rel_max(ts.numpy(), js) <= 1e-6
    else:
        assert np.array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("underflow,bound", [(False, 2e-6), (True, 1e-4)])
def test_wkv_chunked_equals_scan(underflow, bound):
    """Inside the port, the two forms of the recurrence at S = 80 (three
    chunks, the last padded), a carried state."""
    r, k, v, w, u, s0 = wkv_inputs(3, 80)
    if underflow:
        w = underflowing(w, 4)
    co, cs = tssm._wkv_chunked(*map(t, (r, k, v, w, u, s0)))
    so, ss = tssm._wkv_scan(*map(t, (r, k, v, w, u, s0)))
    assert rel_max(co.numpy(), so.numpy()) <= bound
    assert rel_max(cs.numpy(), ss.numpy()) <= bound


@pytest.mark.parametrize("group", [1, 2])
def test_wkv_chunked_groups_of_chunks(group):
    """The state-free terms computed ``group`` chunks at a time give the
    bits of all chunks at once (S = 200: seven chunks, the last padded)."""
    args = list(map(t, wkv_inputs(5, 200)))
    want = tssm._wkv_chunked(*args)
    got = tssm._wkv_chunked(*args, group=group)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _block_args(model, s, seed, carried):
    cfg = model["cfg"]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    state = x_prev = None
    if carried:
        state = (0.1 * rng.standard_normal((B, H, N, N))).astype(np.float32)
        x_prev = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    return x, state, x_prev


def _layer(model, i=1):
    p = layer_slice(model["params"]["blocks"]["seg0"], i)["ssm"]
    return p, jax.tree.map(lambda a: jnp.asarray(a.numpy()), p)


@pytest.mark.parametrize("s,carried", [(8, False), (80, True)])
def test_rwkv6_block_matches_reference(model, s, carried):
    p, jp = _layer(model)
    x, state, x_prev = _block_args(model, s, 5 + s, carried)
    jy, (js, jx) = jax.jit(lambda pp, xx, st, xp: jssm.rwkv6_block(
        pp, xx, model["jcfg"], policy=JMemPolicy(default=None), rng=jax.random.PRNGKey(0),
        name="L.ssm", state=st, x_prev=xp))(jp, x, state, x_prev)
    ty, (ts, tx) = tssm.rwkv6_block(
        p, t(x), model["cfg"], policy=MemPolicy(default=None), rng=PRNGKey(0), name="L.ssm",
        state=None if state is None else t(state), x_prev=None if x_prev is None else t(x_prev))
    assert ty.shape == (B, s, model["cfg"].d_model) and ts.shape == (B, H, N, N)
    assert rel_max(ty.numpy(), jy) <= 1e-5
    assert rel_max(ts.numpy(), js) <= 1e-6
    assert np.array_equal(tx.numpy(), np.asarray(jx))


def test_rwkv6_decode_matches_reference(model):
    p, jp = _layer(model, 0)
    x, state, x_prev = _block_args(model, 1, 9, True)
    jy, js, jx = jax.jit(lambda pp, xx, st, xp: jssm.rwkv6_decode(
        pp, xx, model["jcfg"], policy=JMemPolicy(default=None), rng=jax.random.PRNGKey(0),
        name="L.ssm", state=st, x_prev=xp))(jp, x[:, 0], state, x_prev)
    ty, ts, tx = tssm.rwkv6_decode(p, t(x[:, 0]), model["cfg"], policy=MemPolicy(default=None),
                                   rng=PRNGKey(0), name="L.ssm", state=t(state),
                                   x_prev=t(x_prev))
    assert ty.shape == (B, model["cfg"].d_model)
    assert rel_max(ty.numpy(), jy) <= 1e-5
    assert rel_max(ts.numpy(), js) <= 1e-6
    assert np.array_equal(tx.numpy(), np.asarray(jx))


def test_init_rwkv6_state_matches_reference(model):
    got = tssm.init_rwkv6_state(model["cfg"], 3, 2, torch.bfloat16, device="cpu")
    want = jssm.init_rwkv6_state(model["jcfg"], 3, 2, jnp.bfloat16)
    for k in ("s", "x_prev"):
        assert tuple(got[k].shape) == want[k].shape and not got[k].any()
    assert got["s"].dtype == torch.float32 and got["x_prev"].dtype == torch.bfloat16


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(6)
    x = (3 * rng.standard_normal((64, 128)) + 1).astype(np.float32)
    scale, bias = (rng.standard_normal(128).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda a: jcommon.norm(a, {"scale": scale, "bias": bias}, "ln"))(x)
    got = tcommon.norm(t(x), {"scale": t(scale), "bias": t(bias)}, "ln")
    assert rel_max(got.numpy(), want) <= 1e-6
