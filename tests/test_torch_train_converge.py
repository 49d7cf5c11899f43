"""The reference's convergence tests (``tests/test_train_serve.py``) on
the port alone: a one-layer qwen2-smoke (vocab 64) learns the
predict-previous-token task in 30 AdamW steps, digitally (the loss falls
below 0.7 of its start) and through the straight-through estimator on
``mem_fast`` hardware layers with var 0.02 (below 0.8; paper Fig. 16).
The batches are the reference's ``jax.random.randint`` draws, made by the
port's ``randint`` (bitwise)."""
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import DPEConfig, MemPolicy
from repro_torch.core.prng import PRNGKey, randint
from repro_torch.models import init_params
from repro_torch.optim import adamw
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(1)


def _copy_task(vocab, b, s, seed):
    toks = randint(PRNGKey(seed), (b, s), 0, vocab)
    return {"tokens": toks, "labels": torch.cat([toks[:, :1], toks[:, :-1]], dim=1)}


def _train_losses(policy, steps=30):
    cfg = get_smoke("qwen2-0.5b").replace(vocab=64, n_layers=1)
    opt = adamw(lr=3e-3)
    step = make_train_step(cfg, opt, policy, compute_dtype=torch.float32, loss_chunk=32)
    state = init_train_state(init_params(cfg, 0, device="cpu"), opt)
    losses = []
    for i in range(steps):
        state, m = step(state, _copy_task(cfg.vocab, 8, 32, i % 4))
        losses.append(float(m["loss"]))
    return losses


def test_training_reduces_loss():
    losses = _train_losses(None)
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


def test_mem_training_reduces_loss():
    losses = _train_losses(MemPolicy(default=DPEConfig(mode="fast", var=0.02)))
    assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])
