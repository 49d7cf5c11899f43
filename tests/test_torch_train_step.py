"""The port's train step (``repro_torch.train.make_train_step``) against
the reference's jitted ``repro.train.make_train_step``.

qwen2-smoke (h2o-danube-smoke, vocab 64, for microbatching, as the
reference's ``test_microbatch_equivalence``) with the reference's
weights, float32, the same numpy batches on both sides.  Classes:

* 3 steps of the launcher's optimiser (AdamW, cosine schedule, clip 1.0)
  and its default policy (digital), remat on: each step's loss within
  rel 1e-5 (bitwise here) and gradient norm within rel 1e-5; every
  parameter within max rel 5e-5, except the key projection's bias: the
  softmax is invariant to it, so its true gradient is zero and what the
  two sides compute is rounding noise, which AdamW's first steps scale to
  about ``lr``: it is held to ``2 * sum(lr)`` per element;
* microbatches 4: loss within rel 1e-5 of the reference's microbatches 4
  and parameters within max rel 1e-5; against one batch, the reference
  test's bounds (loss within 1e-3, parameters within 5e-4);
* one SGD step with ``GradCompression``: loss within rel 1e-6,
  parameters within max rel 1e-4 (an int8 code that flips moves a
  gradient by one quantum, absmax / 127), bf16 error-feedback buffers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.distributed.compression import GradCompression as JGradCompression
from repro.models import init_params as j_init_params
from repro.optim import adamw as j_adamw
from repro.optim import cosine_schedule as j_cosine
from repro.optim import sgd as j_sgd
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch.configs import get_smoke
from repro_torch.distributed.compression import GradCompression
from repro_torch.models import init_params
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw, cosine_schedule, sgd
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.step import _split_microbatches

torch.set_num_threads(1)


def max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels.copy())})


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{pre}/{k}")]
    return [pre]


@pytest.fixture(scope="module")
def qwen():
    cfg, jcfg = get_smoke("qwen2-0.5b"), j_get_smoke("qwen2-0.5b")
    return jcfg, cfg, j_init_params(jcfg, jax.random.PRNGKey(0)), init_params(cfg, 0, device="cpu")


def test_train_steps_match_reference(qwen):
    jcfg, cfg, jp, tp = qwen
    jopt = j_adamw(lr=j_cosine(3e-3, warmup=1, total=3))
    sched = cosine_schedule(3e-3, warmup=1, total=3)
    topt = adamw(lr=sched)
    jstep = jax.jit(j_make_step(jcfg, jopt, compute_dtype=jnp.float32, loss_chunk=8))
    tstep = make_train_step(cfg, topt, compute_dtype=torch.float32, loss_chunk=8)
    js, ts = j_init_state(jp, jopt), init_train_state(tp, topt)
    for i in range(3):
        jb, tb = _batch(cfg.vocab, 2, 16, 10 + i)
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-5 * float(jm["grad_norm"])
    assert int(ts["step"]) == 3 and ts["step"].dtype == torch.int32
    noise = 2 * sum(float(sched(i)) for i in range(3))
    for path, a, b in zip(_paths(tp), jax.tree.leaves(js["params"]), tree_leaves(ts["params"])):
        if path.endswith("k_proj/b"):
            assert float(np.abs(np.asarray(a) - b.numpy()).max()) <= noise, path
        else:
            assert max_rel(a, b) <= 5e-5, (path, max_rel(a, b))


def test_split_microbatches_in_order():
    b = {"tokens": torch.arange(24).reshape(8, 3)}
    parts = _split_microbatches(b, 4)
    assert len(parts) == 4 and torch.equal(parts[1]["tokens"], b["tokens"][2:4])


def test_microbatches_match_reference():
    jcfg = j_get_smoke("h2o-danube-1.8b").replace(vocab=64)
    cfg = get_smoke("h2o-danube-1.8b").replace(vocab=64)
    assert cfg.swa_window == jcfg.swa_window == 32
    jp, tp = j_init_params(jcfg, jax.random.PRNGKey(0)), init_params(cfg, 0, device="cpu")
    jb, tb = _batch(64, 8, 32, 1)
    jopt, opt = j_sgd(lr=1e-2, momentum=0.0), sgd(lr=1e-2, momentum=0.0)
    jf4 = jax.jit(j_make_step(jcfg, jopt, compute_dtype=jnp.float32, loss_chunk=32,
                              microbatches=4))
    t1 = make_train_step(cfg, opt, compute_dtype=torch.float32, loss_chunk=32)
    t4 = make_train_step(cfg, opt, compute_dtype=torch.float32, loss_chunk=32, microbatches=4)
    js, jm = jf4(j_init_state(jp, jopt), jb)
    s1, m1 = t1(init_train_state(tp, opt), tb)
    s4, m4 = t4(init_train_state(tp, opt), tb)
    assert abs(float(m4["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-3
    for a, b, c in zip(jax.tree.leaves(js["params"]), tree_leaves(s4["params"]),
                       tree_leaves(s1["params"])):
        assert max_rel(a, b) <= 1e-5
        assert float((b - c).abs().max()) <= 5e-4


def test_train_step_with_grad_compression_matches_reference(qwen):
    jcfg, cfg, jp, tp = qwen
    jopt, topt = j_sgd(lr=1e-2), sgd(lr=1e-2)
    jgc, tgc = JGradCompression(), GradCompression()
    jstep = jax.jit(j_make_step(jcfg, jopt, compute_dtype=jnp.float32, loss_chunk=16,
                                grad_compression=jgc))
    tstep = make_train_step(cfg, topt, compute_dtype=torch.float32, loss_chunk=16,
                            grad_compression=tgc)
    js = dict(j_init_state(jp, jopt), ef=jgc.init(jp))
    ts = dict(init_train_state(tp, topt), ef=tgc.init(tp))
    jb, tb = _batch(cfg.vocab, 2, 16, 4)
    js, jm = jstep(js, jb)
    ts, tm = tstep(ts, tb)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6 * float(jm["loss"])
    worst = max(max_rel(a, b) for a, b in zip(jax.tree.leaves(js["params"]),
                                              tree_leaves(ts["params"])))
    assert worst <= 1e-4, worst
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(ts["ef"]))


def test_step_leaves_the_old_state_alone(qwen):
    """A step returns a new state; the state it was given keeps its
    values (so an async checkpoint of it stays valid)."""
    _, cfg, _, tp = qwen
    opt = adamw(lr=1e-2)
    state = init_train_state({k: v for k, v in tp.items()}, opt)
    before = [t.clone() for t in tree_leaves(state)]
    new, _ = make_train_step(cfg, opt, compute_dtype=torch.float32, loss_chunk=16)(
        state, _batch(cfg.vocab, 2, 16, 5)[1])
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state)))
    assert int(new["step"]) == 1 and int(state["step"]) == 0
