"""The port's checkpointing and fault tolerance: the reference's
``tests/test_checkpoint_ft.py`` on the port (all but the mesh-bound
tests: elastic restore onto a new sharding, ``compressed_psum``), and
checkpoints crossing between the frameworks.

Both packages write the same format (``step_<N>/process_0.npz`` of
``leaf_<i>`` plus ``meta.json`` with JAX's path strings), so a train
state saved by ``repro.checkpoint`` restores into the port bit for bit,
and the reverse.  An async save copies the leaves to host memory before
it returns: a later in-place update does not reach the file.
"""
import json
import time

import jax
import jax.numpy as jnp

import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import get_smoke as j_get_smoke
from repro.models import init_params as j_init_params
from repro.optim import adamw as j_adamw
from repro.train import init_train_state as j_init_state
from repro_torch.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    wait_for_saves,
)
from repro_torch.configs import get_smoke
from repro_torch.distributed.ft import StepMonitor, plan_elastic_mesh, run_with_recovery
from repro_torch.models import init_params
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.train import init_train_state

torch.set_num_threads(1)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(16, 8, generator=g), "b": torch.zeros(8)},
        "opt": {"m": {"w": torch.ones(16, 8), "b": torch.zeros(8)}},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _template(state):
    return {k: _template(v) for k, v in state.items()} if isinstance(state, dict) else \
        torch.empty_like(state)


def test_save_restore_roundtrip(tmp_path):
    st = _state()
    save_checkpoint(tmp_path, 7, st, async_save=False)
    assert latest_step(tmp_path) == 7
    restored, step = restore_checkpoint(tmp_path, _template(st))
    assert step == 7
    for a, b in zip(tree_leaves(st), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_save_and_keep_last_k(tmp_path):
    st = _state()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, st, async_save=True, keep=2)
    wait_for_saves()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps[-1] == 5 and len(steps) <= 2


def test_tree_mismatch_rejected(tmp_path):
    save_checkpoint(tmp_path, 1, _state(), async_save=False)
    bad = {"params": {"w": torch.zeros(16, 8)}, "step": torch.tensor(0, dtype=torch.int32)}
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path, bad)


def test_restore_without_checkpoints_raises(tmp_path):
    assert latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path, _state())


def test_async_snapshot_is_taken_before_an_in_place_update(tmp_path):
    """The save copies the leaves (also CPU tensors, whose ``numpy()``
    shares memory) before its thread writes them."""
    st = _state()
    want = [t.clone() for t in tree_leaves(st)]
    save_checkpoint(tmp_path, 3, st, async_save=True)
    for t in tree_leaves(st):
        t.add_(1)  # an optimiser updating in place
    wait_for_saves()
    restored, _ = restore_checkpoint(tmp_path, _template(st))
    assert all(torch.equal(a, b) for a, b in zip(want, tree_leaves(restored)))


def test_bf16_leaves_roundtrip(tmp_path):
    """bf16 leaves (``GradCompression``'s error feedback) are written as
    the reference writes them (two raw bytes, ``|V2``) and read back by
    their bytes."""
    ef = {"ef": {"w": torch.randn(5, 3).to(torch.bfloat16)}, "step": torch.tensor(1)}
    save_checkpoint(tmp_path, 1, ef, async_save=False)
    assert np.load(tmp_path / "step_1" / "process_0.npz")["leaf_0"].dtype == np.dtype("V2")
    back, _ = restore_checkpoint(tmp_path, _template(ef))
    assert back["ef"]["w"].dtype == torch.bfloat16 and torch.equal(back["ef"]["w"], ef["ef"]["w"])


def test_reference_cannot_restore_its_own_bf16_leaves(tmp_path):
    """Pinned caveat of the reference (ROADMAP §C): numpy stores a bf16
    leaf as ``|V2``, which the reference's ``astype(bfloat16)`` refuses."""
    st = {"ef": jnp.ones((4,), jnp.bfloat16)}
    j_save(tmp_path, 1, st, async_save=False)
    with pytest.raises(ValueError):
        j_restore(tmp_path, jax.eval_shape(lambda: st))


@pytest.fixture(scope="module")
def states():
    jcfg, cfg = j_get_smoke("qwen2-0.5b"), get_smoke("qwen2-0.5b")
    js = j_init_state(j_init_params(jcfg, jax.random.PRNGKey(0)), j_adamw())
    ts = init_train_state(init_params(cfg, 0, device="cpu"), adamw())
    # moments and step away from their zero init
    js = jax.tree.map(lambda a: a + jnp.asarray(0.5, a.dtype) if a.ndim else a + 5, js)
    ts = tree_map(lambda t: t + 0.25 if t.is_floating_point() else t + 3, ts)
    return js, ts


def test_reference_checkpoint_restores_into_the_port(tmp_path, states):
    js, ts = states
    j_save(tmp_path, 5, js, async_save=False)
    got, step = restore_checkpoint(tmp_path, ts)
    assert step == 5
    want = jax.tree.leaves(js)
    assert len(want) == len(tree_leaves(got))
    for a, b in zip(want, tree_leaves(got)):
        assert np.array_equal(np.asarray(a), b.numpy()) and b.dtype == ts_dtype(a)


def ts_dtype(a):
    return {np.dtype("float32"): torch.float32, np.dtype("int32"): torch.int32}[np.asarray(a).dtype]


def test_port_checkpoint_restores_into_the_reference(tmp_path, states):
    js, ts = states
    save_checkpoint(tmp_path, 9, ts, async_save=True)
    wait_for_saves()
    got, step = j_restore(tmp_path, jax.eval_shape(lambda: js))
    assert step == 9
    for a, b in zip(tree_leaves(ts), jax.tree.leaves(got)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_leaf_paths_are_the_references(tmp_path, states):
    """The leaf paths the port writes (``tree_leaves(paths=True)``) are
    those of the reference's ``meta.json``, in the same order."""
    js, ts = states
    j_save(tmp_path, 2, js, async_save=False)
    want = json.loads((tmp_path / "step_2" / "meta.json").read_text())["paths"]
    assert [p for p, _ in tree_leaves(ts, paths=True)] == want


def test_step_monitor_flags_stragglers():
    m = StepMonitor(ema_decay=0.5, straggler_factor=1.5)
    for i in range(3):
        m.start()
        time.sleep(0.01)
        m.stop(i)
    m.start()
    time.sleep(0.08)
    stats = m.stop(99)
    assert stats["straggler"]
    assert m.slow_steps and m.slow_steps[-1][0] == 99


def test_plan_elastic_mesh():
    assert plan_elastic_mesh(256, 16) == (16, 16)
    assert plan_elastic_mesh(240, 16) == (15, 16)  # lost a host
    with pytest.raises(RuntimeError):
        plan_elastic_mesh(8, 16)


def test_run_with_recovery():
    calls = {"n": 0}
    saved = {"state": 0}

    def loop(state):
        calls["n"] += 1
        if calls["n"] < 3:
            saved["state"] = calls["n"]
            raise RuntimeError("node failure")
        return state + 100

    out = run_with_recovery(loop, save_emergency=lambda _: None,
                            restore_latest=lambda: saved["state"], max_restarts=3)
    assert out == 102 and calls["n"] == 3


def test_run_with_recovery_gives_up():
    def loop(state):
        raise RuntimeError("always")

    with pytest.raises(RuntimeError, match="giving up"):
        run_with_recovery(loop, save_emergency=lambda _: None, restore_latest=lambda: 0,
                          max_restarts=1)
