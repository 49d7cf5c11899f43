"""Fig. 17: inference accuracy vs. slice bits and vs. conductance
variation, on a model trained at full precision and deployed directly
(the paper's ``load_state_dict`` + ``update_weight`` flow); port of
``repro/apps/inference_sweep.py``.

Expected: accuracy collapses below ~5 one-bit slices and plateaus above
(<3% loss); variation beyond ~5% degrades sharply.
"""
from __future__ import annotations

import torch

from repro_torch.apps import cli_device
from repro_torch.apps.train_mlp import forward, init_net, program_net, synth_digits, train_step
from repro_torch.core import DPEConfig, SliceSpec
from repro_torch.core.prng import PRNGKey


def _train_full_precision(steps=120, batch=64, lr=0.05, device="cuda"):
    """Train once digitally; return params + test set."""
    x_train, y_train = synth_digits(120, seed=0, device=device)
    x_test, y_test = synth_digits(30, seed=1, device=device)
    params = {k: p.requires_grad_() for k, p in init_net(PRNGKey(0), device).items()}
    mom = {k: torch.zeros_like(p) for k, p in params.items()}
    for step in range(steps):
        i = (step * batch) % (x_train.shape[0] - batch)
        params, mom, _ = train_step(
            params, mom, x_train[i:i + batch], y_train[i:i + batch], None, PRNGKey(0), lr
        )
    return {k: p.detach() for k, p in params.items()}, x_test, y_test


def _acc(params, x, y, cfg, key, batch: int = 64, kernels: bool = True):
    """Accuracy through a *programmed-once* network (weight-stationary):
    the devices are programmed one time for the given ``(cfg, key)`` and
    reused across every evaluation batch."""
    programmed = program_net(params, cfg, key, kernels)
    hits = 0
    with torch.no_grad():
        for i in range(0, x.shape[0], batch):
            logits = forward(params, x[i:i + batch], cfg, key, programmed, kernels)
            hits += int((torch.argmax(logits, 1) == y[i:i + batch]).sum())
    return hits / x.shape[0]


def run(bit_range=(2, 3, 4, 5, 6, 8), variations=(0.0, 0.02, 0.05, 0.1, 0.2),
        device: str = "cuda", kernels: bool = True):
    params, x_test, y_test = _train_full_precision(device=device)
    fp_acc = _acc(params, x_test, y_test, None, PRNGKey(0), kernels=kernels)
    by_bits = {}
    for nbits in bit_range:
        sp = SliceSpec("int", (1,) * nbits)  # all one-bit slices (paper)
        cfg = DPEConfig(input_spec=sp, weight_spec=sp, var=0.02, mode="fast")
        by_bits[nbits] = _acc(params, x_test, y_test, cfg, PRNGKey(1), kernels=kernels)
    by_var = {}
    for var in variations:
        sp = SliceSpec("int", (1, 1, 2, 4))
        cfg = DPEConfig(
            input_spec=sp, weight_spec=sp, var=var, mode="fast",
            noise_mode="program" if var > 0 else "off",
        )
        # one programmed model per noise trial, reused across the test set
        accs = [
            _acc(params, x_test, y_test, cfg, PRNGKey(10 + c), kernels=kernels)
            for c in range(5)
        ]
        by_var[var] = sum(accs) / len(accs)
    return {"fp_acc": fp_acc, "acc_by_bits": by_bits, "acc_by_var": by_var}


if __name__ == "__main__":
    out = run(device=cli_device())
    print(f"full-precision acc: {out['fp_acc']:.3f}")
    print("bits:", {k: round(v, 3) for k, v in out["acc_by_bits"].items()})
    print("var: ", {k: round(v, 3) for k, v in out["acc_by_var"].items()})
